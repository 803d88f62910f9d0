"""Real model configs -> the paper's microservice abstraction (the port's
copy of ``repro/microservice/``)."""
from repro_torch.microservice.partition import (  # noqa: F401
    StageSpec, decompose, profile_stage_ms, to_application)
