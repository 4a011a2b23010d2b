"""Port of ``repro.dualmesh``: the paper's dual-core design flow for LM
serving on one card.

  partition  - the c/p split of the card's SMs (Eq.10), and the splits
               the planner prices without making them
  cost       - the card's 3-term roofline stage model (Eq.5-7)
  schedule   - N-stream staggered scheduling, Alg.1 load balance and
               makespan-aware admission
  search     - branch and bound over theta (§V-B), on the card's SMs or
               on abstract cards
  runtime    - continuous batching on the two cores (chunked prefill on
               c, fused decode groups on p)
"""
from repro_torch.dualmesh.cost import CardModel, StageCost, decode_cost, \
    prefill_cost
from repro_torch.dualmesh.partition import (DualStreams, SplitPlan,
                                            abstract_split, card_split,
                                            split_streams)
from repro_torch.dualmesh.schedule import (ALLOCATIONS, AdmissionPlan,
                                           DualSchedule, MeshGroup, Stage,
                                           best_schedule, build,
                                           load_balance, plan_admission,
                                           request_stages, wave_makespan)
from repro_torch.dualmesh.search import (TP_CANDIDATES, DualSearchResult,
                                         card_memory, card_model,
                                         makespan_lower_bound, search)
from repro_torch.dualmesh.runtime import DualMeshRunner, ServeResult

__all__ = ["CardModel", "StageCost", "decode_cost", "prefill_cost",
           "DualStreams", "SplitPlan", "abstract_split", "card_split",
           "split_streams", "ALLOCATIONS", "AdmissionPlan", "DualSchedule",
           "MeshGroup", "Stage", "best_schedule", "build", "load_balance",
           "plan_admission", "request_stages", "wave_makespan",
           "TP_CANDIDATES", "DualSearchResult", "card_memory", "card_model",
           "makespan_lower_bound", "search", "DualMeshRunner",
           "ServeResult"]
