"""Measurement scripts of the port: each is a module run as
``python -m nersemble_tpu_torch.scripts.<name>`` on the GPU."""
