"""Measurement tools of the port, run as ``python -m
panst3r_torch.tools.<name>`` (counterparts of the JAX package's
``tools/``): ``ab_attention_packed`` (the attention A/B at the encoder
tower's shape, K6's only caller) and ``mfu_report`` (FLOPs, seconds and
MFU per stage of a scene)."""
