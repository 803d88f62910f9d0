"""TABLE I of the paper: parameter ranges.

Each simulation trial samples concrete values from these ranges (the paper:
"values for each run are sampled from predefined ranges").

Resource vector order: [CPU, RAM, GPU, VRAM].
Units: workloads/outputs MB, rates MB/ms, deadlines ms, costs arbitrary.

Symbol key (full glossary in ``repro_torch.core.__init__``): per-MS ``a``/``b``
are the workload a_m and output b_m, ``r`` the requirement vector r_m,
``f`` the deterministic core rate f_det, ``f_gamma_*`` the light-MS
Gamma contention model, ``c_dp``/``c_mt``/``c_pl`` the cost terms of
eqs (6)-(7).

The port's copy of ``repro/core/paper_params.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

K_RESOURCES = 4  # CPU, RAM, GPU, VRAM

TABLE_I = {
    "core_ms": {
        "r": [(2, 16), (1, 4), (4, 32), (4, 32)],
        "a": (2.0, 16.0),          # MB workload
        "b": (0.1, 1.0),           # MB output
        "f": (8.0, 32.0),          # MB/ms deterministic rate
        "c_dp": 20.0, "c_mt": 4.0, "c_pl": 0.0,
    },
    "light_ms": {
        "r": [(0.5, 2), (0.0, 0.5), (0.25, 4), (0.0, 1)],
        "a": (0.5, 2.0),
        "b": (0.25, 1.5),
        "f_gamma_shape": (1.0, 2.0),   # Gamma(shape, scale) MB/ms
        "f_gamma_scale": (1.0, 20.0),
        "c_dp": 4.0, "c_mt": 1.0, "c_pl": 0.5,
    },
    "ed": {"R": [(1, 64), (1, 32), (0, 64), (0, 64)]},
    "es": {"R": [(128, 256), (64, 128), (1024, 2048), (256, 512)]},
    "arrival_rate": (0.15, 1.5),       # Poisson mean per (user, type) per ms
    "deadline": (50.0, 100.0),         # ms
    "snr_nakagami_m": (1.5, 3.0),      # Nakagami(m, omega)
    "snr_nakagami_omega": (0.5, 1.0),
    "input_payload": (0.5, 4.0),       # A_n MB
    "link_bw": (0.1, 1.0),             # w MB/ms
    # not tabulated explicitly in Table I; standard choices documented in
    # the reference: per-user uplink bandwidth and link distance/propagation
    "user_bw": (0.2, 1.0),             # b_u MB/ms
    "link_dist_km": (0.5, 10.0),
    "prop_speed_km_per_ms": 200.0,     # fiber ~2/3 c
}

# Evaluation scenario scale (Sec. IV: 4 task types, 6 core, 9 light MSs)
N_TASK_TYPES = 4
N_CORE_MS = 6
N_LIGHT_MS = 9
N_EDS = 6
N_ESS = 4
N_USERS = 6

# effective-capacity violation probability used by the proposal
EPSILON = 0.2
