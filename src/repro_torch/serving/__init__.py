"""Serving layer of the port: the monolithic and pipelined engines, and
the scheduling policies they delegate to."""
from repro_torch.serving.engine import (  # noqa: F401
    PagedServingEngine, Request, ServingEngine)
from repro_torch.serving.pipeline import (  # noqa: F401
    PLACEMENT_STRATEGIES, PagedPipelinedEngine, PipelinedEngine,
    place_stages)
from repro_torch.serving.scheduler import (  # noqa: F401
    POLICIES, QOS_CLASSES, EDFCapacityPolicy, EDFPolicy, FIFOPolicy,
    QoSClass, SchedulerPolicy, get_qos, goodput, make_policy,
    per_class_stats, slo_met)
from repro_torch.serving.speculative import (  # noqa: F401
    ModelDraft, NgramDraft, SpecConfig, spec_supported)
