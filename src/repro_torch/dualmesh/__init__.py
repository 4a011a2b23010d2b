"""Port of ``repro.dualmesh``: the c/p split of one card into two CUDA
streams, the card cost model, the admission planner and the LM runtime."""
