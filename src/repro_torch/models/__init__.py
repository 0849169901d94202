"""The LM stack of the port: serving (prefill and decode) and training of
dense models.

Counterpart of ``repro.models`` for the block kinds the port runs so far
(``attn_dense``, ``attn_local``; dense swiglu / geglu / gelu FFNs).
Attention over a whole sequence goes through the hand-written flash
kernel (``repro_torch.kernels.flash_attention``), whose gradient is the
dense formula's autograd; decode attends over the KV cache with plain
tensor code, as the JAX package does with XLA.
"""
