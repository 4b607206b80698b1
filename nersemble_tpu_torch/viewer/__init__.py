from nersemble_tpu_torch.viewer.server import (
    ViewerServer,
    encode_image,
    orbit_pose,
    serve_over_ranks,
)

__all__ = ["ViewerServer", "encode_image", "orbit_pose", "serve_over_ranks"]
