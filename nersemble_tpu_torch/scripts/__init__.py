"""Scripts of the port, each a module run as
``python -m nersemble_tpu_torch.scripts.<name>``: the train CLI
(``train_nersemble``), the serving CLIs (``evaluate_nersemble``,
``render_nersemble``, ``view_nersemble``) and the measurement scripts (on
the GPU)."""
