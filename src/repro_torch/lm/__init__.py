"""Port of ``repro.lm``: the dense and MoE transformers (config, modules,
model); SSM, hybrid, encoder-decoder and M-RoPE blocks are not ported
yet."""
