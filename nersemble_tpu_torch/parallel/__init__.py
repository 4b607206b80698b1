"""Data parallelism over torch.distributed (port of nersemble_tpu/parallel/):
``mesh`` holds the ranks and their collectives, ``launch`` starts them."""
