"""Data parallelism across cards over ``torch.distributed`` (``dist.py``)
and the training statistics (``stats.py``)."""
