"""The port's A/B probes of the attention kernels, one module per script of
the JAX package's ``scripts/`` (ab_transpose_free, ab_attention_layout,
ab_head_packing). Importing a probe does nothing; each runs on one CUDA
device as ``python -m dreamlab_tpu_torch.scripts.<name>``.
"""
