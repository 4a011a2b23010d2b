"""PyTorch/CUDA port of the dual-core overlay processor for light-weight
CNNs.

Mirrors the module layout of the JAX package ``repro`` (the reference, which
this package never imports): ``core`` (graph, PE/latency model, Alg.1
scheduler, fusion planner, instruction compiler and cycle simulator),
``models`` (zoo graphs, forwards, parameters), ``kernels`` (hand-written
CUDA kernels K1-K7 and their plain PyTorch versions), ``dualcore`` (step
programs and the pipelined c/p runtime), ``lm`` and ``configs`` (the
language models, their train and serve steps, and the configurations the
port runs), ``dualmesh`` (the LM's c/p runtime, partition and admission
plan), ``serving`` (the streaming engines), ``data`` and ``train`` (the
token pipeline, optimizers, checkpoints and the training runner) and
``launch`` (the ``serve`` and ``train`` CLIs).

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
a wrapper launches its kernel on a CUDA tensor and runs the plain version on
a CPU tensor.
"""
