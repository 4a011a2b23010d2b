"""Port of ``repro.lm``: the dense-transformer part (config, modules,
model); MoE, SSM, hybrid and encoder-decoder blocks are not ported yet."""
