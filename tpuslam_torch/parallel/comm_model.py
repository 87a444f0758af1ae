"""Analytic communication accounting and a first-order scaling model for the
multi-device tiers (counterpart of `tpuslam.parallel.comm_model`).

Each collective's payload is a static function of the graph shape, so the
per-iteration volume of every tier can be written down (the byte functions
below, copied from the JAX package) and checked against what the code
moves (`parallel.instrument.collective_payload_bytes`). On top of it, a
first-order time model

    t(D) = t_comp(1)/D + bytes_on_wire(D) / bandwidth + n_collectives(D) * latency

with bytes_on_wire the ring all-reduce cost 2(D-1)/D x payload for psums
and (D-1)/D x gathered for all_gathers. The links are the caller's: a
`CommModel` states the bandwidth and latency within a fast domain (the
ranks of one NVLink domain, say) and across domains (the network between
hosts), and the domain size. There are no defaults: the JAX package's figures
describe TPU links, and a single card measures no link, so the model's
numbers are only as good as what the caller puts in.

Volumes, read off the solvers:

- `distributed_gn_step` (edge-sharded Schur, parallel/distributed.py):
  psums the whole assembled system per iteration: h_diag [P,3,3] + h_off
  [P,3,3] + W [3P, 2L] + Hll [L,2,2] + gp [P,3] + gl [L,2].
- `chain_gn_step` (replicated reduced solve, parallel/chain.py): psum of
  Hll and gl (O(L)) + all_gather of the W rows [3P, 2L], the Hpp rows, gp
  and the poses.
- `chain_gn_step_dd`: psum of Hll and gl (O(L)), of the [m, m] interface,
  and of the landmark update (O(L)); m = 3D + 3 + 2*shared_cap.
- `chain_gn_step_dd_resident` (parallel/resident.py): the [m, m]
  interface + the shared rows of Hll and gl [shared_cap] only.
- the fusion's sharded dedup (parallel/fusion.py): all_gather of the [S*L]
  labels per round.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CommModel", "tier_bytes_per_iteration", "predict_times",
           "predict_efficiency", "hier_bytes_per_iteration",
           "hier_comm_time", "hier3_bytes_per_iteration", "hier3_comm_time",
           "flat_comm_time", "predict_efficiency_hier",
           "predict_efficiency_weak", "online_comm_time",
           "predict_efficiency_weak_online"]

F32 = 4


def tier_bytes_per_iteration(tier: str, *, P: int, L: int, D: int,
                             shared_cap: int = 64, SL: int | None = None,
                             dedup_iters: int = 8) -> dict:
    """Per-GN-iteration collective payloads (bytes, f32) and counts for a
    tier, as a dict {payload_psum, payload_gather, n_collectives}."""
    if tier == "distributed":          # edge-sharded Schur
        payload = (P * 9 + P * 9 + 2 * (3 * P) * L + L * 4 + P * 3
                   + L * 2) * F32
        return dict(payload_psum=payload, payload_gather=0, n_collectives=1)
    if tier == "chain_replicated":
        b = P // D
        gathered = ((3 * b) * 2 * L + 9 * b * 2 + 3 * b + 3 * b) * F32 * D
        return dict(payload_psum=(L * 4 + L * 2) * F32,
                    payload_gather=gathered, n_collectives=6)
    if tier == "chain_dd":
        m = 3 * D + 3 + 2 * shared_cap
        return dict(payload_psum=(L * 6 + m * m + m + L * 2) * F32,
                    payload_gather=D * F32, n_collectives=4)
    if tier == "chain_dd_resident":
        m = 3 * D + 3 + 2 * shared_cap
        return dict(payload_psum=(shared_cap * 6 + m * m + m) * F32,
                    payload_gather=D * F32, n_collectives=3)
    if tier == "fusion_dedup":
        assert SL is not None
        return dict(payload_psum=0, payload_gather=SL * F32 * dedup_iters,
                    n_collectives=dedup_iters)
    raise ValueError(f"unknown tier {tier}")


@dataclass(frozen=True)
class CommModel:
    """The links of the model, all required: bandwidth (bytes/s) and
    latency per collective (s) within a fast domain of `domain_size` ranks
    and across domains."""
    link_bw_bytes_per_s: float
    link_latency_s: float
    cross_bw_bytes_per_s: float
    cross_latency_s: float
    domain_size: int


def predict_times(tier: str, t_comp_1dev_s: float, D: int, *, P: int, L: int,
                  model: CommModel, shared_cap: int = 64, iterations: int = 1,
                  SL: int | None = None) -> dict:
    """First-order t(D) = t_comp/D + comm on the domain's links; returns
    seconds and the breakdown."""
    v = tier_bytes_per_iteration(tier, P=P, L=L, D=D,
                                 shared_cap=shared_cap, SL=SL)
    ring = 2.0 * (D - 1) / D
    gath = (D - 1) / D
    t_comm = iterations * (
        (ring * v["payload_psum"] + gath * v["payload_gather"])
        / model.link_bw_bytes_per_s
        + v["n_collectives"] * model.link_latency_s * D ** 0.5)
    t_comp = t_comp_1dev_s / D
    return dict(t_total_s=t_comp + t_comm, t_comp_s=t_comp,
                t_comm_s=t_comm, bytes_psum=v["payload_psum"],
                bytes_gather=v["payload_gather"])


def predict_efficiency(tier: str, t_comp_1dev_s: float, D: int, *, P: int,
                       L: int, model: CommModel, shared_cap: int = 64,
                       iterations: int = 1, SL: int | None = None) -> float:
    """Parallel efficiency t(1)/(D * t(D)) under the model."""
    t_d = predict_times(tier, t_comp_1dev_s, D, P=P, L=L,
                        shared_cap=shared_cap, model=model,
                        iterations=iterations, SL=SL)["t_total_s"]
    return t_comp_1dev_s / (D * t_d)


def hier_bytes_per_iteration(D: int, tray: int, *,
                             shared_per_boundary: float = 2.0) -> dict:
    """Per-iteration payloads of the two-level hierarchical resident DD
    solve (parallel/hier.py), split by the domain the collective rides:
    level 1 within a tray, level 2 (and the landmark psums) across trays.

    The flat shared set grows with the block count (each block boundary
    contributes ~`shared_per_boundary` straddling landmarks), so the flat
    interface m = 3D + 3 + 2*c*D grows linearly in D; the hierarchy keeps
    the big exchange within a tray (ms ~ m/T + K) and sends only
    mk = 3T + 3 + 2*c*T across trays.
    """
    G = tray
    T = max(D // G, 1)
    c = shared_per_boundary
    lsh = int(c * D)
    lsh_t = int(c * (G - 1)) + 1
    lsh_x = int(c * T) + 1
    wt = 3 * (G - 1) + 2 * lsh_t
    mk = 3 * T + 3 + 2 * lsh_x
    ms = wt + mk
    return dict(
        payload_psum_tray=(ms * ms + ms) * F32,          # level 1, within a tray
        payload_psum_cross=(mk * mk + mk + lsh * 8) * F32,  # level 2 + landmark psums
        n_collectives_tray=2, n_collectives_cross=3,
        ms=ms, mk=mk, lsh=lsh)


def hier_comm_time(D: int, tray: int, *, model: CommModel,
                   shared_per_boundary: float = 2.0, iterations: int = 1) -> float:
    """Per-solve communication time of the hierarchical solve: level 1 on
    the links within a tray, level 2 across trays."""
    v = hier_bytes_per_iteration(D, tray,
                                 shared_per_boundary=shared_per_boundary)
    G = tray
    T = max(D // G, 1)
    ring_g = 2.0 * (G - 1) / G
    ring_t = 2.0 * (T - 1) / T if T > 1 else 0.0
    return iterations * (
        ring_g * v["payload_psum_tray"] / model.link_bw_bytes_per_s
        + ring_t * v["payload_psum_cross"] / model.cross_bw_bytes_per_s
        + v["n_collectives_tray"] * model.link_latency_s * G ** 0.5
        + v["n_collectives_cross"] * model.cross_latency_s * max(T, 1) ** 0.5)


def predict_efficiency_hier(t_comp_1dev_s: float, D: int, tray: int, *,
                            model: CommModel, shared_per_boundary: float = 2.0,
                            iterations: int = 1) -> float:
    """Strong-scaling efficiency of the hierarchical solve (a fixed problem
    split D ways)."""
    t_comm = hier_comm_time(D, tray, shared_per_boundary=shared_per_boundary,
                            model=model, iterations=iterations)
    t_d = t_comp_1dev_s / D + t_comm
    return t_comp_1dev_s / (D * t_d)


def hier3_bytes_per_iteration(D: int, tray: int, pod: int, *,
                              shared_per_boundary: float = 2.0) -> dict:
    """Per-iteration payloads of the three-level nested dissection
    (parallel/hier3.py): trays of `tray` ranks eliminate their interiors
    with a within-tray psum; the tray-boundary systems of one pod of `pod`
    ranks are summed within the pod, still inside the fast domain; only the
    O(n_pods) pod-boundary system crosses pods.
    """
    G = tray
    T_pod = max(pod // G, 1)        # trays per pod
    n_pods = max(D // pod, 1)
    c = shared_per_boundary
    lsh = int(c * D)
    lsh_t = int(c * (G - 1)) + 1
    lsh_p = int(c * T_pod) + 1
    lsh_x = int(c * n_pods) + 1
    wt = 3 * (G - 1) + 2 * lsh_t                  # tray interior width
    mk2 = 3 * T_pod + 2 * lsh_p                   # pod-level boundary
    mk3 = 3 * n_pods + 3 + 2 * lsh_x              # cross-pod boundary
    ms1 = wt + mk2 + mk3                          # level-1 sub-interface
    ms2 = mk2 + mk3                               # level-2 sub-interface
    return dict(
        payload_psum_l1=(ms1 * ms1 + ms1) * F32,
        payload_psum_l2=(ms2 * ms2 + ms2) * F32,
        payload_psum_l3_cross=(mk3 * mk3 + mk3 + lsh * 8) * F32,
        n_collectives_in=4, n_collectives_cross=2,
        ms1=ms1, ms2=ms2, mk3=mk3, lsh=lsh)


def hier3_comm_time(D: int, tray: int, pod: int = 256, *, model: CommModel,
                    shared_per_boundary: float = 2.0, iterations: int = 1) -> float:
    """Per-solve comm time of the three-level solve: levels 1-2 on the
    links within a domain (tray group, then pod group), level 3 across
    pods."""
    pod = min(pod, D)
    v = hier3_bytes_per_iteration(D, tray, pod,
                                  shared_per_boundary=shared_per_boundary)
    G = tray
    T_pod = max(pod // G, 1)
    n_pods = max(D // pod, 1)
    ring_g = 2.0 * (G - 1) / G
    ring_p = 2.0 * (T_pod - 1) / T_pod if T_pod > 1 else 0.0
    ring_x = 2.0 * (n_pods - 1) / n_pods if n_pods > 1 else 0.0
    return iterations * (
        (ring_g * v["payload_psum_l1"]
         + ring_p * v["payload_psum_l2"]) / model.link_bw_bytes_per_s
        + ring_x * v["payload_psum_l3_cross"] / model.cross_bw_bytes_per_s
        + v["n_collectives_in"] * model.link_latency_s
        * max(pod, 1) ** 0.5
        + (v["n_collectives_cross"] * model.cross_latency_s
           * max(n_pods, 1) ** 0.5 if n_pods > 1 else 0.0))


def _links(model: CommModel, D: int, cross_domain: bool):
    """(bandwidth, latency) of a flat collective over D ranks: across
    domains once D exceeds one (with `cross_domain`)."""
    if cross_domain and D > model.domain_size:
        return model.cross_bw_bytes_per_s, model.cross_latency_s
    return model.link_bw_bytes_per_s, model.link_latency_s


def flat_comm_time(D: int, *, model: CommModel, shared_per_boundary: float = 2.0,
                   iterations: int = 1, cross_domain: bool = True) -> float:
    """Per-solve comm time of the flat resident DD at fleet scale: the
    shared set grows with the block count (lsh = c*D), so the single
    [m, m] interface psum has m = 3D + 3 + 2cD. Past one domain the flat
    psum crosses domains (`cross_domain`)."""
    c = shared_per_boundary
    lsh = int(c * D)
    m = 3 * D + 3 + 2 * lsh
    ring = 2.0 * (D - 1) / D
    bw, lat = _links(model, D, cross_domain)
    payload = (m * m + m + lsh * 8) * F32
    return iterations * (ring * payload / bw + 3 * lat * D ** 0.5)


def online_comm_time(D: int, *, bytes_per_lap: int, n_collectives: int,
                     model: CommModel, cross_domain: bool = True) -> float:
    """Per-lap communication time of an online pass whose payload per lap
    was measured (`instrument.collective_payload_bytes`) rather than
    derived. Ring factor and the domain convention match
    `flat_comm_time`."""
    ring = 2.0 * (D - 1) / D
    bw, lat = _links(model, D, cross_domain)
    return ring * bytes_per_lap / bw + n_collectives * lat * D ** 0.5


def predict_efficiency_weak_online(t_lap_1dev_s: float, D: int, *,
                                   bytes_per_lap: int, n_collectives: int,
                                   model: CommModel) -> float:
    """Weak-scaling efficiency of an online pass whose per-rank compute and
    payload stay constant in D: t_lap / (t_lap + t_comm(D))."""
    t_comm = online_comm_time(D, bytes_per_lap=bytes_per_lap,
                              n_collectives=n_collectives, model=model)
    return t_lap_1dev_s / (t_lap_1dev_s + t_comm)


def predict_efficiency_weak(tier: str, t_comp_per_dev_s: float, D: int, *,
                            model: CommModel, tray: int = 8,
                            shared_per_boundary: float = 2.0,
                            iterations: int = 1) -> float:
    """Weak-scaling efficiency (the chain grows with D, per-rank compute
    constant): t_pd / (t_pd + t_comm(D)). Tiers: 'chain_dd_resident' (flat
    interface, grows with D), 'chain_dd_hier' (two-level) or
    'chain_dd_hier3' (three-level)."""
    if tier == "chain_dd_hier3":
        t_comm = hier3_comm_time(D, tray,
                                 shared_per_boundary=shared_per_boundary,
                                 model=model, iterations=iterations)
    elif tier == "chain_dd_hier":
        t_comm = hier_comm_time(D, tray,
                                shared_per_boundary=shared_per_boundary,
                                model=model, iterations=iterations)
    elif tier == "chain_dd_resident":
        t_comm = flat_comm_time(D, shared_per_boundary=shared_per_boundary,
                                model=model, iterations=iterations)
    else:
        raise ValueError(tier)
    return t_comp_per_dev_s / (t_comp_per_dev_s + t_comm)
