"""The LM stack of the port: serving (prefill and decode) and training.

Counterpart of ``repro.models``, with every block kind of the reference
(``attn_dense``, ``attn_local``, ``mla_dense``, ``attn_moe``, ``rec``,
``mlstm``, ``slstm``; dense swiglu / geglu / gelu FFNs and the MoE's
``gather`` and expert-parallel ``a2a`` paths, the latter over the ranks of
the ambient mesh, ``meshctx``).  Attention over a whole sequence goes through the
hand-written flash kernel (``repro_torch.kernels.flash_attention``), whose
gradient is the dense formula's autograd; decode attends over the KV cache
(MLA absorbed over its latent cache) with plain tensor code, as the JAX
package does with XLA.
"""
