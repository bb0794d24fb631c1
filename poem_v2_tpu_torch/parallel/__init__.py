"""Data parallel over ``torch.distributed`` (counterpart of ``poem_v2_tpu/parallel``)."""
