"""Port of ``repro.lm``: configs, modules, the model of every family
(dense, MoE, SSM, hybrid, encoder-decoder, M-RoPE) and the train and
serve step factories."""
