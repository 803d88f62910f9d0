"""Heterogeneous edge network (Fig. 2): EDs + ESs, links, users.

Topology: ESs form a full mesh among themselves (backhaul); every ED
attaches to its two nearest ESs; users attach to one ED each over a
Nakagami-fading wireless uplink.

The port's copy of ``repro/core/network.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import paper_params as pp


# node tiers for heterogeneous topologies (make_tiered_network)
TIER_DEVICE, TIER_ED, TIER_ES, TIER_CLOUD = 0, 1, 2, 3

# canonical resource-column names for `EdgeNetwork.R` (Table I order);
# use `resource_index` instead of hardcoding column numbers so consumers
# stay correct if a narrower R matrix is supplied
RESOURCE_NAMES = ("cpu", "ram", "gpu", "vram")


def resource_index(name: str) -> int:
    """Column index of a named resource in ``EdgeNetwork.R``."""
    try:
        return RESOURCE_NAMES.index(name)
    except ValueError:
        raise KeyError(f"unknown resource {name!r}; "
                       f"known: {RESOURCE_NAMES}") from None


@dataclass
class EdgeNetwork:
    n_nodes: int
    is_es: np.ndarray            # (V,) bool
    R: np.ndarray                # (V, K) capacities
    bw: np.ndarray               # (V, V) link bandwidth MB/ms (0 = no link)
    dist: np.ndarray             # (V, V) km
    user_ed: np.ndarray          # (U,) entry-node index of each user
    user_bw: np.ndarray          # (U,) uplink bandwidth b_u MB/ms
    snr_m: np.ndarray            # (U,) Nakagami shape
    snr_omega: np.ndarray        # (U,) Nakagami spread
    prop_speed: float = pp.TABLE_I["prop_speed_km_per_ms"]
    tier: np.ndarray = field(default=None, repr=False)  # (V,) TIER_* ints

    # filled by prepare()
    hop_next: np.ndarray = field(default=None, repr=False)
    net_ms: np.ndarray = field(default=None, repr=False)
    # routed-path transfer delay is affine in the payload:
    #   path_ms(v1, v2, mb) = mb * path_invbw[v1, v2] + path_prop[v1, v2]
    # (sum of per-hop 1/bw, and of per-hop dist/prop_speed, along the
    # shortest-hop route); precomputed so the simulator can score whole
    # candidate-node vectors at once
    path_invbw: np.ndarray = field(default=None, repr=False)
    path_prop: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        if self.tier is None:  # classic two-tier topology
            self.tier = np.where(self.is_es, TIER_ES, TIER_ED)

    def nodes_in_tier(self, t: int) -> np.ndarray:
        return np.flatnonzero(self.tier == t)

    @property
    def n_users(self) -> int:
        return len(self.user_ed)

    # ------------------------------------------------------------------
    def link_ms(self, v1: int, v2: int, mb: float) -> float:
        """Transmission + propagation delay for `mb` MB over one hop
        (eq. 2); 0 if same node."""
        if v1 == v2:
            return 0.0
        bw = self.bw[v1, v2]
        assert bw > 0, f"no link {v1}->{v2}"
        return mb / bw + self.dist[v1, v2] / self.prop_speed

    def path_ms(self, v1: int, v2: int, mb: float) -> float:
        """Multi-hop routed transfer delay along the precomputed
        shortest-hop route (affine in ``mb``)."""
        if v1 == v2:
            return 0.0
        out = mb * self.path_invbw[v1, v2] + self.path_prop[v1, v2]
        assert np.isfinite(out), f"no route {v1}->{v2}"
        return float(out)

    def path_ms_row(self, v1: int, mb: float) -> np.ndarray:
        """Vector of routed transfer delays from ``v1`` to every node."""
        return mb * self.path_invbw[v1] + self.path_prop[v1]

    def sample_uplink_ms(self, rng, u: int, payload_mb: float) -> float:
        """Eq. (1) with Nakagami-m fading SNR."""
        m, omega = self.snr_m[u], self.snr_omega[u]
        gamma = rng.gamma(m, omega / m)  # Nakagami power ~ Gamma(m, omega/m)
        rate = self.user_bw[u] * np.log2(1.0 + gamma)
        return payload_mb / max(rate, 1e-6)

    def sample_uplink_ms_batch(self, rng, users: np.ndarray,
                               payload_mb: np.ndarray) -> np.ndarray:
        """Eq. (1) for a batch of (user, payload) pairs — ONE Gamma draw
        for the whole batch, so per-slot arrival sampling is a handful
        of vector calls rather than per-task scalar draws."""
        if len(users) == 0:
            return np.zeros(0)
        m, omega = self.snr_m[users], self.snr_omega[users]
        gamma = rng.gamma(m, omega / m)
        rate = self.user_bw[users] * np.log2(1.0 + gamma)
        return payload_mb / np.maximum(rate, 1e-6)

    def mean_uplink_ms(self, u: int, payload_mb: float) -> float:
        """Mean-value analysis version of eq. (1): E[gamma] = omega for
        Nakagami-m power (Jensen approx on log2)."""
        omega = self.snr_omega[u]
        rate = self.user_bw[u] * np.log2(1.0 + omega)
        return payload_mb / max(rate, 1e-6)

    # ------------------------------------------------------------------
    def prepare(self, mean_transfer_mb: float = 1.0):
        """All-pairs shortest paths (Floyd-Warshall) with edge weight =
        transfer(1MB) + propagation; stores next-hop for routing."""
        v = self.n_nodes
        w = np.full((v, v), np.inf)
        np.fill_diagonal(w, 0.0)
        for i in range(v):
            for j in range(v):
                if i != j and self.bw[i, j] > 0:
                    w[i, j] = (mean_transfer_mb / self.bw[i, j]
                               + self.dist[i, j] / self.prop_speed)
        nxt = np.tile(np.arange(v), (v, 1))
        nxt[w == np.inf] = -1
        for i in range(v):
            nxt[i, i] = i
        for k in range(v):
            for i in range(v):
                improved = w[i, k] + w[k] < w[i]
                w[i, improved] = w[i, k] + w[k, improved]
                nxt[i, improved] = nxt[i, k]
        self.hop_next = nxt
        self.net_ms = w
        # walk every route simultaneously to decompose path delay into
        # its payload-proportional and propagation components (affine
        # coefficients consumed by path_ms / path_ms_row)
        with np.errstate(divide="ignore"):
            edge_inv = np.where(self.bw > 0, 1.0 / np.where(
                self.bw > 0, self.bw, 1.0), np.inf)
        np.fill_diagonal(edge_inv, 0.0)
        edge_prop = self.dist / self.prop_speed
        invbw = np.zeros((v, v))
        prop = np.zeros((v, v))
        cur = np.tile(np.arange(v)[:, None], (1, v))
        tgt = np.tile(np.arange(v)[None, :], (v, 1))
        unreachable = nxt < 0
        for _ in range(v):
            act = (cur != tgt) & ~unreachable
            if not act.any():
                break
            step = nxt[cur[act], tgt[act]]
            invbw[act] += edge_inv[cur[act], step]
            prop[act] += edge_prop[cur[act], step]
            cur[act] = step
        invbw[unreachable] = np.inf
        prop[unreachable] = np.inf
        self.path_invbw = invbw
        self.path_prop = prop
        return self


def make_network(rng: np.random.Generator,
                 n_eds: int = pp.N_EDS, n_ess: int = pp.N_ESS,
                 n_users: int = pp.N_USERS) -> EdgeNetwork:
    v = n_eds + n_ess
    is_es = np.array([False] * n_eds + [True] * n_ess)
    R = np.zeros((v, pp.K_RESOURCES))
    for i in range(v):
        spec = pp.TABLE_I["es" if is_es[i] else "ed"]["R"]
        R[i] = [rng.uniform(lo, hi) for lo, hi in spec]

    lo, hi = pp.TABLE_I["link_dist_km"]
    pos = rng.uniform(0, hi, size=(v, 2))  # km field
    dist = np.clip(np.linalg.norm(pos[:, None] - pos[None, :], axis=-1),
                   lo, None)

    bw = np.zeros((v, v))

    def connect(i, j):
        w = rng.uniform(*pp.TABLE_I["link_bw"])
        bw[i, j] = bw[j, i] = w

    # ES full mesh
    for i in range(n_eds, v):
        for j in range(i + 1, v):
            connect(i, j)
    # each ED -> two nearest ESs
    for i in range(n_eds):
        es_order = np.argsort(dist[i, n_eds:]) + n_eds
        for j in es_order[:2]:
            connect(i, int(j))

    user_ed = rng.integers(0, n_eds, size=n_users)
    net = EdgeNetwork(
        n_nodes=v, is_es=is_es, R=R, bw=bw, dist=dist,
        user_ed=user_ed,
        user_bw=rng.uniform(*pp.TABLE_I["user_bw"], size=n_users),
        snr_m=rng.uniform(*pp.TABLE_I["snr_nakagami_m"], size=n_users),
        snr_omega=rng.uniform(*pp.TABLE_I["snr_nakagami_omega"],
                              size=n_users),
    )
    return net.prepare()


# capacity scaling / backhaul parameters for the four-tier topology
TIERED = {
    "device_R_scale": 0.25,      # device caps = scale * ED range
    "cloud_R_scale": 8.0,        # cloud caps = scale * ES range
    "cloud_bw": (2.0, 5.0),      # MB/ms ES <-> cloud backhaul
    "cloud_dist_km": (200.0, 500.0),   # long-haul propagation dominates
    "device_bw": (0.05, 0.3),    # MB/ms constrained device <-> ED link
}


def make_tiered_network(rng: np.random.Generator,
                        n_devices: int = 4,
                        n_eds: int = pp.N_EDS, n_ess: int = pp.N_ESS,
                        n_cloud: int = 1,
                        n_users: int = pp.N_USERS) -> EdgeNetwork:
    """Heterogeneous cloud/edge/device topology (scenario `tiered`).

    Node order: devices [0, nd), EDs, ESs, cloud last.  Devices are
    weak near-user nodes on constrained links; the cloud is a huge
    far-away pool reached over high-bandwidth, high-propagation-delay
    backhaul.  Users enter at a device when devices exist, so payloads
    must either execute on starved local silicon or pay the haul up.
    """
    v = n_devices + n_eds + n_ess + n_cloud
    tier = np.array([TIER_DEVICE] * n_devices + [TIER_ED] * n_eds
                    + [TIER_ES] * n_ess + [TIER_CLOUD] * n_cloud)
    is_es = tier >= TIER_ES
    ed0, es0, cl0 = n_devices, n_devices + n_eds, n_devices + n_eds + n_ess

    R = np.zeros((v, pp.K_RESOURCES))
    for i in range(v):
        if tier[i] == TIER_DEVICE:
            spec, scale = pp.TABLE_I["ed"]["R"], TIERED["device_R_scale"]
        elif tier[i] == TIER_ED:
            spec, scale = pp.TABLE_I["ed"]["R"], 1.0
        elif tier[i] == TIER_ES:
            spec, scale = pp.TABLE_I["es"]["R"], 1.0
        else:
            spec, scale = pp.TABLE_I["es"]["R"], TIERED["cloud_R_scale"]
        R[i] = [scale * rng.uniform(lo, hi) for lo, hi in spec]

    lo, hi = pp.TABLE_I["link_dist_km"]
    pos = rng.uniform(0, hi, size=(v, 2))
    dist = np.clip(np.linalg.norm(pos[:, None] - pos[None, :], axis=-1),
                   lo, None)
    # the cloud sits far outside the metro field
    for c in range(cl0, v):
        dist[c, :] = dist[:, c] = rng.uniform(*TIERED["cloud_dist_km"],
                                              size=v)
        dist[c, c] = 0.0

    bw = np.zeros((v, v))

    def connect(i, j, rng_range):
        w = rng.uniform(*rng_range)
        bw[i, j] = bw[j, i] = w

    # ES full mesh
    for i in range(es0, cl0):
        for j in range(i + 1, cl0):
            connect(i, j, pp.TABLE_I["link_bw"])
    # each ED -> two nearest ESs
    for i in range(ed0, es0):
        es_order = es0 + np.argsort(dist[i, es0:cl0])
        for j in es_order[:2]:
            connect(i, int(j), pp.TABLE_I["link_bw"])
    # each device -> its nearest ED, over a constrained link
    for i in range(n_devices):
        j = ed0 + int(np.argmin(dist[i, ed0:es0]))
        connect(i, j, TIERED["device_bw"])
    # cloud -> every ES over fat long-haul pipes
    for c in range(cl0, v):
        for j in range(es0, cl0):
            connect(c, j, TIERED["cloud_bw"])

    entry_pool = n_devices if n_devices > 0 else n_eds
    entry_off = 0 if n_devices > 0 else ed0
    user_ed = entry_off + rng.integers(0, entry_pool, size=n_users)
    net = EdgeNetwork(
        n_nodes=v, is_es=is_es, R=R, bw=bw, dist=dist,
        user_ed=user_ed,
        user_bw=rng.uniform(*pp.TABLE_I["user_bw"], size=n_users),
        snr_m=rng.uniform(*pp.TABLE_I["snr_nakagami_m"], size=n_users),
        snr_omega=rng.uniform(*pp.TABLE_I["snr_nakagami_omega"],
                              size=n_users),
        tier=tier,
    )
    return net.prepare()
