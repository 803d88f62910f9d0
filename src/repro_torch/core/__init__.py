"""The paper's planning plane, the port's copy (numpy only).

Modules:
  paper_params        Table I parameter ranges + samplers
  graph               microservice + task-DAG model (Fig. 1)
  network             heterogeneous edge network (Fig. 2), eqs (1)-(2)
  qos                 mean-value heuristics z~, d~, Q (eqs 15-16)
  static_placement    sparsity-constrained integer program (14)+(16)
  effective_capacity  eqs (20)-(21): E_c(theta), g_{m,eps}(y)
  lyapunov            virtual queues (18) + drift-plus-penalty (19)
  online_controller   Algorithm 1 (greedy light-MS deployment)
  baselines           LBRR / GA / PropAvg
  simulator           event-driven slot simulator (Sec. IV)
  simulator_scalar    the fixed-semantics scalar engine (its oracle)
  experiment          single-trial driver shared by benches/examples

The static tier places the pipelined engines' core stages
(``serving/pipeline.py::place_stages``); the online tier's virtual queues
and effective-capacity budget drive the ``edf`` / ``edf_ec`` scheduling
policies (``serving/scheduler.py``).  The simulators, Algorithm 1's
controller and the baselines run the paper's simulation study, driven
by ``repro_torch.experiments`` (scenario registry, replication runner,
results and reports).  Each module is a copy of its counterpart in
``repro/core/``, held against it on equal seeds by
tests/test_torch_planning.py (placement) and tests/test_torch_simulator.py
(the study: trial dicts equal key for key); the reference's package
docstring keeps the paper-notation glossary.
"""
from repro_torch.core.graph import Application, Microservice, TaskType  # noqa: F401
from repro_torch.core.network import EdgeNetwork  # noqa: F401
