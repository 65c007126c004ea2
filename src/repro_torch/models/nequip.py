"""NequIP (arXiv:2101.03164), the E(3)-equivariant message-passing
interatomic potential in the reference's Cartesian form for l_max = 2
(counterpart of ``repro.models.nequip``).

Features per node and channel are Cartesian tensors:

    s [N, C]         l = 0 scalars
    v [N, C, 3]      l = 1 vectors
    t [N, C, 3, 3]   l = 2 symmetric traceless tensors

Every tensor-product path l1 x l2 -> l3 with l <= 2 is a dense contraction
(dot, cross, matvec, symmetric traceless outer product), equivariant under
O(3) by construction.  Path weights are per-(path, channel) functions of
the edge length: a Bessel radial basis with a polynomial envelope, then an
MLP.  A message pass is an edge gather, the contractions, and a segment sum
into the receivers: one ``index_add_`` into zeros per feature order.

``_segment_sum`` keeps ``jax.ops.segment_sum``'s rule: an id outside
``[0, n)`` (negative ones too) contributes nothing.  Its row is zeroed and
its index clamped, so no host sync and no device assert (ROADMAP C13).
Edge *sources* are gathered as the reference's gather reads them: a
negative source counts from the end, and the result is clamped into
``[0, N)`` (ROADMAP C18), again with no host sync and no device assert.

``_message_layer`` runs edges in ``n_edge_chunks`` chunks (the reference's
``lax.scan``) so that only one chunk's messages are live; each chunk's
aggregates are formed into zeros and added to the running sums in the
reference's order.  A chunk count that does not divide E raises
``ValueError`` (the reference fails an ``assert``; ROADMAP C14).

Partitioned message passing (``partitioned_train_step_fn``,
``build_partition``): the reference's distributed-GNN layout, a per-rank
program over a ``launch.mesh.RankMesh``.  The host partitioner gives each
rank a block of nodes and the edges into them (padded to equal counts
with edges into ``dst = nloc``, which ``_segment_sum`` drops) and an
export list: its nodes that other ranks' edges read.  Before each layer
every rank all-gathers its exported rows (the halo; layer 0 exchanges
only ``s``, its ``v`` and ``t`` being zero), and edge sources index
[local nodes | halo].  The energies' partial sums are summed over every
rank; the replicated parameters' gradients, summed over the ranks, are the
dense step's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device
from repro_torch.dist.collectives import all_gather, psum
from repro_torch.models.common import mlp, normal_init

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat_in: int = 1433       # input node feature width (dataset-dependent)
    radial_hidden: int = 64
    readout_hidden: int = 64
    param_dtype: torch.dtype = torch.float32

    @property
    def n_paths(self) -> int:
        return 10


def init_params(cfg: NequIPConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``: each weight
    [din, dout] N(0, 1/din), biases zero, the gates N(0, 0.01), drawn from
    ``generator`` (any generator, or None, for ``"meta"``).  The
    reference's layout and distribution: as there, a layer's ``gate_v``
    and ``gate_t`` are the draws of ``mix_s_self`` and ``mix_s_msg``
    (they share a key) scaled by 0.1.  Its random numbers differ
    (``jax.random``)."""
    dev = resolve_device(device)
    C, dt = cfg.channels, cfg.param_dtype

    def dense(din, dout, scale=None):
        return normal_init(generator, (din, dout), dt, scale or din ** -0.5, dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=dev)

    params = {
        "embed_in": dense(cfg.d_feat_in, C),
        "layers": [],
        "readout_w1": dense(C, cfg.readout_hidden),
        "readout_b1": zeros(cfg.readout_hidden),
        "readout_w2": dense(cfg.readout_hidden, 1),
        "readout_b2": zeros(1),
    }
    for _ in range(cfg.n_layers):
        unit_s_self, unit_s_msg = dense(C, C, 1.0), dense(C, C, 1.0)
        params["layers"].append({
            # radial net: rbf -> hidden -> per-(path, channel) weights
            "rad_w1": dense(cfg.n_rbf, cfg.radial_hidden),
            "rad_b1": zeros(cfg.radial_hidden),
            "rad_w2": dense(cfg.radial_hidden, cfg.n_paths * C),
            "rad_b2": zeros(cfg.n_paths * C),
            # self-interaction channel mixes (per l)
            "mix_s_self": unit_s_self * C ** -0.5,
            "mix_s_msg": unit_s_msg * C ** -0.5,
            "mix_v_self": dense(C, C),
            "mix_v_msg": dense(C, C),
            "mix_t_self": dense(C, C),
            "mix_t_msg": dense(C, C),
            # gates for l > 0 (functions of scalars)
            "gate_v": unit_s_self * 0.1,
            "gate_t": unit_s_msg * 0.1,
        })
    return params


def abstract_params(cfg: NequIPConfig) -> dict:
    """The parameter tree's shapes and dtypes on the ``meta`` device,
    nothing allocated (the reference's ``abstract_params``)."""
    return init_params(cfg, None, device="meta")


# ---------------------------------------------------------------------------
# Geometry pieces
# ---------------------------------------------------------------------------


def bessel_rbf(r, n_rbf: int, cutoff: float):
    """Bessel radial basis sin(n pi r / rc) / r, n = 1..n_rbf, times the
    polynomial cutoff envelope (p = 6): r [...] -> [..., n_rbf]."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rc = cutoff
    rr = torch.clamp(r, min=EPS)[..., None]
    basis = math.sqrt(2.0 / rc) * torch.sin(n * math.pi * rr / rc) / rr
    x = torch.clamp(r / rc, 0.0, 1.0)
    env = 1 - 28 * x**6 + 48 * x**7 - 21 * x**8
    return basis * env[..., None]


def edge_harmonics(edge_vec):
    """(r [E], Y1 = the unit vector u [E, 3], Y2 = u u^T - I/3 [E, 3, 3]).
    A zero-length edge has u = 0 and Y2 = -I/3 in both packages; the
    gradient of r there is 0 in the port (``torch.linalg.norm``) and NaN in
    the reference (``jnp.linalg.norm``; ROADMAP C15)."""
    r = torch.linalg.norm(edge_vec, dim=-1)
    u = edge_vec / torch.clamp(r, min=EPS)[..., None]
    eye = torch.eye(3, dtype=edge_vec.dtype, device=edge_vec.device)
    y2 = u[..., :, None] * u[..., None, :] - eye / 3.0
    return r, u, y2


def _sym_traceless(m):
    sym = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return sym - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def _segment_sum(data, ids, n: int):
    """``jax.ops.segment_sum(data, ids, num_segments=n)``: [n, ...] sums of
    the rows of ``data`` by ``ids``.  A row whose id lies outside [0, n) is
    dropped: zeroed, its index clamped into range, one ``index_add_`` into
    zeros (no host sync, no device assert)."""
    ok = (ids >= 0) & (ids < n)
    rows = torch.where(ok.view(-1, *(1,) * (data.dim() - 1)), data, 0)
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, torch.clamp(ids, 0, n - 1), rows)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _edge_messages(cfg: NequIPConfig, lp, s, v, t, src, dst, r, u, y2, n_nodes):
    """Tensor-product messages of one edge block, summed into the
    receivers: (agg_s [N, C], agg_v [N, C, 3], agg_t [N, C, 3, 3]).
    Sources are read as the reference reads them: negative ones from the
    end, then clamped into [0, N) (module docstring)."""
    C = cfg.channels
    N = s.shape[0]
    src = torch.where(src < 0, src + N, src).clamp(0, N - 1)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    w = mlp(rbf, [lp["rad_w1"], lp["rad_w2"]], [lp["rad_b1"], lp["rad_b2"]],
            act=F.silu).reshape(-1, cfg.n_paths, C)        # [E, P, C]

    ss = s[src]                                            # [E, C]
    vs = v[src]                                            # [E, C, 3]
    ts = t[src]                                            # [E, C, 3, 3]
    u_ = u[:, None, :]                                     # [E, 1, 3]
    y2_ = y2[:, None, :, :]                                # [E, 1, 3, 3]

    # --- tensor-product paths (l1 x l2 -> l3), all l <= 2 -----------------
    m_s = (
        w[:, 0] * ss
        + w[:, 1] * torch.einsum("eci,ei->ec", vs, u)
        + w[:, 2] * torch.einsum("ecij,eij->ec", ts, y2)
    )
    m_v = (
        w[:, 3][..., None] * (ss[..., None] * u_)
        + w[:, 4][..., None] * vs
        + w[:, 5][..., None] * torch.linalg.cross(vs, u_.expand_as(vs), dim=-1)
        + w[:, 6][..., None] * torch.einsum("ecij,ej->eci", ts, u)
    )
    outer_vu = _sym_traceless(vs[..., :, None] * u_[..., None, :])
    m_t = (
        w[:, 7][..., None, None] * (ss[..., None, None] * y2_)
        + w[:, 8][..., None, None] * ts
        + w[:, 9][..., None, None] * outer_vu
    )
    return (_segment_sum(m_s, dst, n_nodes), _segment_sum(m_v, dst, n_nodes),
            _segment_sum(m_t, dst, n_nodes))


def _aggregate(cfg: NequIPConfig, lp, s, v, t, src, dst, r, u, y2, n_nodes,
               n_edge_chunks: int = 1):
    """The messages of all edges summed into ``n_nodes`` receivers, in
    ``n_edge_chunks`` chunks of E / n_edge_chunks (each chunk's sums added
    to the running ones)."""
    E = src.shape[0]
    if n_edge_chunks <= 1:
        return _edge_messages(cfg, lp, s, v, t, src, dst, r, u, y2, n_nodes)
    if E % n_edge_chunks:
        raise ValueError(f"{cfg.name}: {E} edges do not split into {n_edge_chunks} "
                         "equal chunks")
    ce = E // n_edge_chunks
    C = cfg.channels
    agg_s = s.new_zeros((n_nodes, C))
    agg_v = s.new_zeros((n_nodes, C, 3))
    agg_t = s.new_zeros((n_nodes, C, 3, 3))
    for lo in range(0, E, ce):
        c = slice(lo, lo + ce)
        d_s, d_v, d_t = _edge_messages(cfg, lp, s, v, t, src[c], dst[c], r[c], u[c], y2[c],
                                       n_nodes)
        agg_s, agg_v, agg_t = agg_s + d_s, agg_v + d_v, agg_t + d_t
    return agg_s, agg_v, agg_t


def _update(lp, s, v, t, agg_s, agg_v, agg_t):
    """The self-interaction mixes, the gates and the residuals."""
    s_new = s @ lp["mix_s_self"] + agg_s @ lp["mix_s_msg"]
    v_new = (torch.einsum("nci,cd->ndi", v, lp["mix_v_self"])
             + torch.einsum("nci,cd->ndi", agg_v, lp["mix_v_msg"]))
    t_new = (torch.einsum("ncij,cd->ndij", t, lp["mix_t_self"])
             + torch.einsum("ncij,cd->ndij", agg_t, lp["mix_t_msg"]))

    gate_v = torch.sigmoid(s_new @ lp["gate_v"])
    gate_t = torch.sigmoid(s_new @ lp["gate_t"])
    s_out = s + F.silu(s_new)
    v_out = v + v_new * gate_v[..., None]
    t_out = t + t_new * gate_t[..., None, None]
    return s_out, v_out, t_out


def _message_layer(cfg: NequIPConfig, lp, s, v, t, edge_index, r, u, y2, n_nodes,
                   n_edge_chunks: int = 1):
    """One interaction block: the messages of all edges (in
    ``n_edge_chunks`` chunks of E / n_edge_chunks, each chunk's aggregates
    added to the running sums), then the self-interaction mixes, the
    gates and the residuals."""
    agg = _aggregate(cfg, lp, s, v, t, edge_index[0], edge_index[1], r, u, y2, n_nodes,
                     n_edge_chunks)
    return _update(lp, s, v, t, *agg)


def _node_states(cfg: NequIPConfig, params, node_feat, edge_index, edge_vec,
                 n_edge_chunks: int = 1):
    """The node features (s, v, t) after the last interaction block."""
    N = node_feat.shape[0]
    C = cfg.channels
    s = node_feat @ params["embed_in"]
    v = s.new_zeros((N, C, 3))
    t = s.new_zeros((N, C, 3, 3))
    r, u, y2 = edge_harmonics(edge_vec)
    for lp in params["layers"]:
        s, v, t = _message_layer(cfg, lp, s, v, t, edge_index, r, u, y2, N,
                                 n_edge_chunks=n_edge_chunks)
    return s, v, t


def forward_energy(cfg: NequIPConfig, params, node_feat, edge_index, edge_vec, graph_id,
                   n_graphs: int, n_edge_chunks: int = 1):
    """Per-graph energies [n_graphs].

    node_feat f32 [N, F]; edge_index integers [2, E] (src, dst); edge_vec
    f32 [E, 3]; graph_id integers [N] (a node whose id lies outside
    [0, n_graphs) counts in no graph)."""
    s, _, _ = _node_states(cfg, params, node_feat, edge_index, edge_vec, n_edge_chunks)
    node_e = mlp(s, [params["readout_w1"], params["readout_w2"]],
                 [params["readout_b1"], params["readout_b2"]], act=F.silu)[..., 0]
    return _segment_sum(node_e, graph_id, n_graphs)


def forward_train(cfg: NequIPConfig, params, batch, n_graphs: int, n_edge_chunks: int = 1):
    """MSE of the per-graph energies against ``batch["energy"]`` [n_graphs];
    ``batch`` holds ``forward_energy``'s inputs under their names."""
    energies = forward_energy(cfg, params, batch["node_feat"], batch["edge_index"],
                              batch["edge_vec"], batch["graph_id"], n_graphs,
                              n_edge_chunks=n_edge_chunks)
    return torch.mean((energies - batch["energy"]) ** 2)


# ===========================================================================
# Partitioned message passing (distributed-GNN halo exchange)
# ===========================================================================


def halo_bytes_per_layer(n_ranks: int, xmax: int, channels: int) -> int:
    """Bytes the halo tables of one layer after the first hold, summed
    over ranks: the reference's |halo| x C x 13 x 4 (s, v and t in f32),
    |halo| = n_ranks x xmax gathered rows."""
    return n_ranks * xmax * channels * 13 * 4


def partitioned_train_step_fn(cfg: NequIPConfig, mesh, n_graphs: int, n_edge_chunks: int = 1):
    """``loss_fn(params, batch)`` on one rank of ``mesh`` (a
    ``launch.mesh.RankMesh``; every rank calls it together): the MSE
    energy loss of the whole partitioned graph.  ``batch`` holds this
    rank's blocks of ``build_partition``'s arrays (``dist.sharding
    .local_shard`` with the spec ``P(all axes)``; ``energy`` whole):

        node_feat  [N_loc, F]  its node block
        edge_src   [E_loc]     local index, or N_loc + halo row
        edge_dst   [E_loc]     local index (N_loc: padding, dropped)
        edge_vec   [E_loc, 3]
        export_idx [X]         local indices of the rows it exports
        graph_id   [N_loc]     global graph ids
        energy     [n_graphs]

    Parameters are replicated; the loss is the same on every rank.  Each
    rank's gradient is its part of the dense one (``psum``'s backward
    passes the energies' cotangent to each rank's partial sums): their sum
    over the ranks is the dense step's."""

    def halo(x, export_idx):
        return all_gather(x[export_idx], mesh, "all", 0)

    def loss_fn(params, batch):
        src, dst, export_idx = batch["edge_src"], batch["edge_dst"], batch["export_idx"]
        N_loc = batch["node_feat"].shape[0]
        C = cfg.channels
        s = batch["node_feat"] @ params["embed_in"]
        v = s.new_zeros((N_loc, C, 3))
        t = s.new_zeros((N_loc, C, 3, 3))
        r, u, y2 = edge_harmonics(batch["edge_vec"])
        for li, lp in enumerate(params["layers"]):
            ts = torch.cat([s, halo(s, export_idx)])
            if li == 0:  # v and t are zero before the first block: no exchange
                X = ts.shape[0] - N_loc
                tv = torch.cat([v, s.new_zeros((X, C, 3))])
                tt = torch.cat([t, s.new_zeros((X, C, 3, 3))])
            else:
                tv = torch.cat([v, halo(v, export_idx)])
                tt = torch.cat([t, halo(t, export_idx)])
            agg = _aggregate(cfg, lp, ts, tv, tt, src, dst, r, u, y2, N_loc, n_edge_chunks)
            s, v, t = _update(lp, s, v, t, *agg)
        node_e = mlp(s, [params["readout_w1"], params["readout_w2"]],
                     [params["readout_b1"], params["readout_b2"]], act=F.silu)[..., 0]
        e = psum(_segment_sum(node_e, batch["graph_id"], n_graphs), mesh, "all")
        return torch.mean((e - batch["energy"]) ** 2)

    return loss_fn


def build_partition(node_feat, edge_index, edge_vec, graph_id, ndev: int) -> dict:
    """The reference's host partitioner (``repro.models.nequip
    .build_partition``) in numpy, array for array: nodes in ``ndev``
    equal blocks; each block's edges (those into its nodes, in edge order)
    padded to the largest count with edges 0 -> nloc of vector (1e-3, 0,
    0); each block's export list (its nodes that other blocks' edges read,
    sorted, padded with 0 to the longest); sources renumbered into [local |
    halo], the halo being the export lists gathered in rank order.  Global
    arrays whose ``P(all axes)`` blocks are each rank's, as
    ``partitioned_train_step_fn`` takes them (``energy`` is the caller's)."""
    N = node_feat.shape[0]
    if N % ndev:
        raise ValueError(f"{N} nodes do not split into {ndev} equal blocks")
    nloc = N // ndev
    src = np.asarray(edge_index[0]).astype(np.int64)
    dst = np.asarray(edge_index[1]).astype(np.int64)
    edge_vec = np.asarray(edge_vec, np.float32)
    owner, src_owner = dst // nloc, src // nloc

    per_dev = [np.flatnonzero(owner == d) for d in range(ndev)]
    emax = max(1, max(len(x) for x in per_dev))
    exports = [np.unique(src[(src_owner == d) & (owner != d)]) - d * nloc
               for d in range(ndev)]
    xmax = max(1, max(len(x) for x in exports))
    export_idx = np.zeros((ndev, xmax), np.int32)
    halo_pos = np.zeros(N, np.int64)
    for d, ex in enumerate(exports):
        export_idx[d, :len(ex)] = ex
        halo_pos[d * nloc + ex] = d * xmax + np.arange(len(ex))

    e_src = np.zeros((ndev, emax), np.int32)
    e_dst = np.full((ndev, emax), nloc, np.int32)
    e_vec = np.zeros((ndev, emax, 3), np.float32)
    e_vec[:, :, 0] = 1e-3
    for d, idx in enumerate(per_dev):
        sg = src[idx]
        e_src[d, :len(idx)] = np.where(src_owner[idx] == d, sg - d * nloc, nloc + halo_pos[sg])
        e_dst[d, :len(idx)] = dst[idx] - d * nloc
        e_vec[d, :len(idx)] = edge_vec[idx]
    return {
        "node_feat": np.asarray(node_feat, np.float32),
        "edge_src": e_src.reshape(-1),
        "edge_dst": e_dst.reshape(-1),
        "edge_vec": e_vec.reshape(-1, 3),
        "export_idx": export_idx.reshape(-1),
        "graph_id": np.asarray(graph_id, np.int32),
    }
