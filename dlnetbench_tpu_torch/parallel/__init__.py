"""Process groups, collectives and device buffers over
``torch.distributed`` (NCCL on the card, gloo on the CPU)."""
