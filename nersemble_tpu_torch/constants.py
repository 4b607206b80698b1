"""Camera-rig constants (the port's copy of nersemble_tpu/constants.py;
reference: src/nersemble/constants.py:1-5).

The NeRSemble capture rig has 16 synchronized cameras identified by serial
number. 12 are used for training (in a fixed order) and 4 are held out for
novel-view-synthesis evaluation.
"""

CAM_ID_ORDER = [8, 7, 9, 4, 10, 5, 13, 2, 12, 1, 14, 0]
EVALUATION_CAM_IDS = [3, 6, 11, 15]
COMPLETE_CAM_ID_ORDER = CAM_ID_ORDER + EVALUATION_CAM_IDS
SERIALS = [
    "222200042", "222200044", "222200046", "222200040",
    "222200036", "222200048", "220700191", "222200041",
    "222200037", "222200038", "222200047", "222200043",
    "222200049", "222200039", "222200045", "221501007",
]

# Default per-participant scene boxes (world AABBs, already in viewer
# convention; reference: scripts/train/train_nersemble.py:40-48).
SCENE_BOXES = {
    18: [[-1.8, -2.3, -2.5], [1.8, 1.3, 2]],
    30: [[-2.5, -1.8, -2.5], [2.2, 1.8, 2]],
    38: [[-1.8, -1.5, -2.5], [2.2, 2.2, 2]],
    85: [[-2, -1.8, -2.5], [2.2, 1.7, 2]],
    97: [[-2.2, -2.8, -2.5], [2.2, 2.2, 2]],
    124: [[-2.2, -2.5, -2.5], [2.2, 1.5, 2]],
    175: [[-2.3, -2, -2.5], [2, 2, 2]],
}

DEFAULT_SCENE_BOX = [[-2.5, -2, -2.5], [2.5, 3, 2]]

# Captured image resolution before the 2x training downscale
# (reference: src/nersemble/nerfstudio/dataparser/nersemble_dataparser.py:155-157).
ORIGINAL_IMAGE_WIDTH = 2200
ORIGINAL_IMAGE_HEIGHT = 3208
