"""The graph-sharded walk: the walk with every graph access routed to the
shard that owns the node.

Port of `pseudoaligner_tpu/ops/map_kernel.py::_walk` in its global mode,
with `fetch = parallel/sharded_index.py::_routed_fetch_factory` and
`cond_all` the psum-OR of the loop's liveness.  Each shard holds one
contiguous block of Nb node rows and its slice of the 2-bit pool
(`sharded_index.build_sharded_graph`); node n belongs to shard
min(n // Nb, S - 1).

`graph_walk` drives the walk of every shard this process holds in
lockstep between collectives, as `_routed_seed_tables` does.  Per shard the
walk state st [b, NSTATE] int32 (the columns below) and the [b, M, 2]
(node, ec) push buffer stay in device memory, and the walk runs as steps:

    init                         the start state and the first requests
    left loop, per iteration:    fetch(row, window) -> left_a
                                 fetch(row)         -> left_b
    forward loop, per iteration: fetch(row, window) -> forward
    finish                       caps and the output encoding

A fetch is: each lane's request at slot [owner, lane] of a [S, b, 2]
buffer (written by the step before it), an all_to_all, the owner serving
what it received (`serve_fetch`), and an all_to_all back, after which a
lane reads its response at [owner, lane].  Lanes with nothing to fetch
send (-1, 0), which the owner answers with zeros; the reference fetches
node 0 for them instead.  No lane reads those responses, so no result
changes.

A loop runs another iteration while its cap allows and any lane of any
shard is active: the all_reduce of the shards' any-active flags, read on
the host, so every shard (and every process of the group) issues the
same collectives.  A lane advances only while it is active, so the trip
count changes no result.  Lazy seeds are off in this mode (the k-mer-
partitioned engine turns them off) and so are the reference's lane
compaction and straight-line knobs, which global mode disables too.

Each step has a plain PyTorch function here and a CUDA kernel of the same
signature (`ops/kernels.py`: gwalk_*_cuda, csrc/gwalk.cu K10;
gfetch_cuda, csrc/gfetch.cu K11).  `graph_walk` takes the kernels for
CUDA tensors and the plain steps for CPU tensors; the tests run the plain
steps against the reference on the CPU and chip_smoke.py holds the kernels
equal to them on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.hashing import MASK32
from ..ops.map_kernel import MapResult, _as_i32, _push, _result, segment

# the columns of the walk state st [b, NSTATE] (csrc/gwalk.cu's enum)
(L_ACT,   # left loop: the read is active
 L_NODE,  # left loop: current node
 L_PKO,   # left loop: offset in the node
 L_LAST,  # left loop: last read position still to compare
 F_ACT,   # forward loop: the read is active
 F_NODE,  # forward loop: current node
 F_KOFF,  # forward loop: the k-mer's offset in the node
 F_KPOS,  # forward loop: the k-mer's read position
 COV,     # coverage
 MM,      # mismatches
 NN,      # pushes (may exceed max_nodes)
 FOLLOW,  # left_a -> left_b: the successor node, or -1
 ) = range(12)
NSTATE = 12
ROW = 12  # int32 per node row


def window_words(meta) -> int:
    """Words of a fetched compare window: at least read_len bases."""
    return (meta.read_len + 15) // 16


def _owner(kmeta, node: torch.Tensor) -> torch.Tensor:
    return torch.clamp(node // kmeta.node_block, max=kmeta.n_shards - 1)


def _write_requests(kmeta, req, node, delta) -> None:
    """req [S, b, 2] in place: (node, delta) at [owner, lane] for lanes
    with node >= 0, (-1, 0) in every other slot."""
    req[..., 0] = -1
    req[..., 1] = 0
    lanes = (node >= 0).nonzero(as_tuple=True)[0]
    n = node[lanes].to(torch.int64)
    o = _owner(kmeta, n)
    req[o, lanes, 0] = n.to(torch.int32)
    req[o, lanes, 1] = delta[lanes].to(torch.int32)


def _response(kmeta, back, node) -> torch.Tensor:
    """[b, width] int64: each lane's response from its node's owner (node
    0's owner for lanes that fetched nothing; nobody reads those)."""
    lanes = torch.arange(back.shape[1], device=back.device)
    return back[_owner(kmeta, node.clamp(min=0)), lanes].to(torch.int64)


def _bases(words, pos) -> torch.Tensor:
    """[b, n] 2-bit base codes at positions pos [b, n] of packed words
    [b, nw] (base t at bits 2*(t & 15) of word t >> 4); 0 outside."""
    nw = words.shape[1]
    w = (pos >> 4).clamp(0, nw - 1)
    v = (words.gather(1, w).to(torch.int64) >> ((pos & 15) * 2)) & 3
    return torch.where((pos >= 0) & (pos < 16 * nw), v, 0)


def walk_init(meta, kmeta, nh3, lens, st, buf, req_l, req_f) -> None:
    """Plain init: nh3 [b, P, 3], lens [b] -> the start state of both
    loops in st, buf set to -1, the first left requests (row and window of
    the seed node, delta pko - (L-1)) in req_l and the first forward
    requests (delta koff + k) in req_f."""
    q0 = nh3[:, 0, 0].to(torch.int64)
    node0 = nh3[:, 0, 1].to(torch.int64)
    off0 = nh3[:, 0, 2].to(torch.int64)
    seeded = q0 < meta.n_positions
    thresh = torch.floor(
        torch.tensor(meta.left_extend_fraction, dtype=torch.float32)
        * lens.to(torch.float32)).to(torch.int64)
    lact = seeded & (q0 >= thresh)
    pko = torch.where(off0 > 0, off0 - 1, 0)
    zeros = torch.zeros_like(q0)
    cols = {L_ACT: lact, L_NODE: node0, L_PKO: pko, L_LAST: q0 - 1,
            F_ACT: seeded, F_NODE: node0, F_KOFF: off0, F_KPOS: q0,
            COV: zeros, MM: zeros, NN: zeros, FOLLOW: zeros - 1}
    for c, v in cols.items():
        st[:, c] = v.to(torch.int32)
    buf.fill_(-1)
    _write_requests(kmeta, req_l, torch.where(lact, node0, -1),
                    pko - (meta.read_len - 1))
    _write_requests(kmeta, req_f, torch.where(seeded, node0, -1),
                    off0 + meta.k)


def walk_left_a(meta, kmeta, packed, back, st, req) -> None:
    """Plain left_a: the left body up to the successor, from each active
    lane's row and window (ascending from nstart + pko - (L-1), so base
    nstart + pko - i is window position L-1-i) in back [S, b, ROW + WW];
    writes the successor's row request (delta 0) into req."""
    L = meta.read_len
    act = st[:, L_ACT] != 0
    pko = st[:, L_PKO].to(torch.int64)
    last = st[:, L_LAST].to(torch.int64)
    r = _response(kmeta, back, st[:, L_NODE].to(torch.int64))
    j = torch.arange(L, device=st.device)
    ref = _bases(r[:, ROW:], (L - 1 - j)[None, :].expand(st.shape[0], L))
    rd = _bases(packed, last[:, None] - j[None, :])
    matched, mm_add, prem = segment(ref != rd, torch.minimum(last, pko) + 1,
                                    meta.allowed_mismatches)
    lp2 = last - matched
    stop = (lp2 == -1) | prem
    nb = _bases(packed, lp2.clamp(min=0)[:, None])[:, 0]
    follow = act & ~stop & (((r[:, 2] >> (4 + nb)) & 1) == 1)
    nxt = r.gather(1, (8 + nb)[:, None])[:, 0]
    st[:, COV] += torch.where(act, matched, 0).to(torch.int32)
    st[:, MM] += torch.where(act, mm_add, 0).to(torch.int32)
    st[:, L_LAST] = torch.where(act, lp2, last).to(torch.int32)
    st[:, FOLLOW] = torch.where(follow, nxt, -1).to(torch.int32)
    _write_requests(kmeta, req, st[:, FOLLOW], torch.zeros_like(last))


def walk_left_b(meta, kmeta, back, st, buf, req) -> None:
    """Plain left_b: push each following lane's successor with the class
    from its row in back [S, b, ROW], move the lane there (pko = len - k)
    and write the next left requests into req."""
    f = st[:, FOLLOW].to(torch.int64)
    fol = f >= 0
    r = _response(kmeta, back, f)
    st[:, NN] = _push(buf, st[:, NN].to(torch.int64), f, r[:, 3],
                      fol).to(torch.int32)
    st[:, L_NODE] = torch.where(fol, f, st[:, L_NODE]).to(torch.int32)
    st[:, L_PKO] = torch.where(fol, r[:, 1] - meta.k,
                               st[:, L_PKO]).to(torch.int32)
    st[:, L_ACT] = fol.to(torch.int32)
    _write_requests(kmeta, req, torch.where(fol, f, -1),
                    st[:, L_PKO].to(torch.int64) - (meta.read_len - 1))


def walk_forward(meta, kmeta, packed, lens, nh3, back, st, buf, req) -> None:
    """Plain forward: one forward body of each active lane from its row
    and window (ascending from nstart + koff + k) in back [S, b, ROW + WW]:
    push, compare, then follow r_edge or re-seed from the lane's nh3 row;
    writes the next forward requests (delta koff + k) into req."""
    L, k, P = meta.read_len, meta.k, meta.n_positions
    act = st[:, F_ACT] != 0
    node = st[:, F_NODE].to(torch.int64)
    koff = st[:, F_KOFF].to(torch.int64)
    kpos = st[:, F_KPOS].to(torch.int64) + k
    cov = st[:, COV].to(torch.int64) + k
    lens64 = lens.to(torch.int64)
    r = _response(kmeta, back, node)
    st[:, NN] = _push(buf, st[:, NN].to(torch.int64), node, r[:, 3],
                      act).to(torch.int32)
    maxm = torch.clamp(torch.minimum(lens64 - kpos, r[:, 1] - (koff + k)),
                       min=0)
    j = torch.arange(L, device=st.device)
    ref = _bases(r[:, ROW:], j[None, :].expand(st.shape[0], L))
    rd = _bases(packed, kpos[:, None] + j[None, :])
    matched, mm_add, prem = segment(ref != rd, maxm, meta.allowed_mismatches)
    kpos = kpos + matched
    cov = cov + matched
    at_end = kpos >= lens64
    nb = _bases(packed, kpos.clamp(0, L - 1)[:, None])[:, 0]
    hasr = ~prem & (((r[:, 2] >> nb) & 1) == 1)
    follow = act & ~at_end & hasr
    nxt = r.gather(1, (4 + nb)[:, None])[:, 0]
    tbl = act & ~at_end & ~hasr & (kpos <= lens64 - k)
    lanes = torch.arange(st.shape[0], device=st.device)
    trip = nh3[lanes, kpos.clamp(0, P - 1)].to(torch.int64)
    found = tbl & (trip[:, 0] < P)
    node = torch.where(follow, nxt, torch.where(found, trip[:, 1], node))
    koff = torch.where(follow, 0, torch.where(found, trip[:, 2], koff))
    kpos = torch.where(follow, kpos - (k - 1),
                       torch.where(found, trip[:, 0], kpos))
    cov = torch.where(follow, cov - (k - 1), cov)
    active = follow | found
    for c, v in ((F_NODE, node), (F_KOFF, koff), (F_KPOS, kpos), (COV, cov)):
        st[:, c] = torch.where(act, v, st[:, c]).to(torch.int32)
    st[:, MM] += torch.where(act, mm_add, 0).to(torch.int32)
    st[:, F_ACT] = active.to(torch.int32)
    _write_requests(kmeta, req, torch.where(active, node, -1), koff + k)


def walk_finish(meta, kmeta, st, buf) -> MapResult:
    """Plain finish: capped (a cap left a loop active, or pushes beyond
    max_nodes), then the walk's output encoding (map_kernel._result)."""
    n_nodes = st[:, NN].to(torch.int64)
    capped = n_nodes > meta.max_nodes
    if meta.max_left_iters > 0:
        capped |= st[:, L_ACT] != 0
    if meta.max_walk_iters > 0:
        capped |= st[:, F_ACT] != 0
    return _result(meta, buf, st[:, COV].to(torch.int64),
                   st[:, MM].to(torch.int64), n_nodes, capped)


def serve_fetch(kmeta, me, recv, node_rows, pool, ww) -> torch.Tensor:
    """Plain owner-side fetch of shard `me`: requests recv [S, b, 2] int32
    (node, delta), its block's node_rows [Nb, ROW] and flat pool words
    [R] int32 -> responses [S, b, ROW + ww] int32: the row of local node
    clip(node - me*Nb, 0, Nb-1) and ww words of 2-bit bases ascending from
    max(row[0] + delta, 0), zero past the pool's end; all zeros for node
    < 0 (no request)."""
    S, b = recv.shape[:2]
    n = recv[..., 0].reshape(-1).to(torch.int64)
    d = recv[..., 1].reshape(-1).to(torch.int64)
    nb = kmeta.node_block
    rows = node_rows[(n - me * nb).clamp(0, nb - 1)]
    out = torch.zeros((S * b, ROW + ww), dtype=torch.int32,
                      device=recv.device)
    out[:, :ROW] = rows
    if ww:
        q = (rows[:, 0].to(torch.int64) + d).clamp(min=0)
        words = torch.cat([pool.to(torch.int64) & MASK32,
                           torch.zeros(1, dtype=torch.int64,
                                       device=pool.device)])
        at = ((q >> 4)[:, None] + torch.arange(ww + 1, device=q.device)
              ).clamp(max=pool.shape[0])
        w = words[at]
        sh = (2 * (q & 15))[:, None]
        out[:, ROW:] = _as_i32(((w[:, :-1] >> sh) | (w[:, 1:] << (32 - sh)))
                               & MASK32)
    out[n < 0] = 0
    return out.reshape(S, b, ROW + ww)


class Steps(NamedTuple):
    """The walk's step functions: the plain ones or the kernels."""

    init: Callable
    left_a: Callable
    left_b: Callable
    forward: Callable
    finish: Callable
    serve: Callable


PLAIN_STEPS = Steps(walk_init, walk_left_a, walk_left_b, walk_forward,
                    walk_finish, serve_fetch)


def kernel_steps() -> Steps:
    """K10's entries and K11 (ops/kernels.py)."""
    from ..ops import kernels as kn

    return Steps(kn.gwalk_init_cuda, kn.gwalk_left_a_cuda,
                 kn.gwalk_left_b_cuda, kn.gwalk_forward_cuda,
                 kn.gwalk_finish_cuda, kn.gfetch_cuda)


# the arguments each step writes in place (positions in its signature)
_WRITES = {"init": (4, 5, 6, 7), "left_a": (4, 5), "left_b": (3, 4, 5),
           "forward": (6, 7, 8), "finish": (), "serve": ()}


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def paired_steps(first: Steps, second: Steps, err: dict) -> Steps:
    """Steps that run each step of `first` and of `second` on copies of
    the same inputs and keep, per step name, the largest absolute
    difference of what the two wrote or returned in err[name]; the walk
    goes on with `first`'s.  With first = kernel_steps() and second =
    PLAIN_STEPS it holds every kernel launch of a walk against its plain
    version (chip_smoke.py, the gpu tests)."""

    def pair(name):
        f1, f2 = getattr(first, name), getattr(second, name)

        def call(*args):
            copies = [a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args]
            got = f1(*args)
            want = f2(*copies)
            outs = [(args[i], copies[i]) for i in _WRITES[name]]
            if isinstance(got, tuple):
                outs += list(zip(got, want))
            elif got is not None:
                outs.append((got, want))
            err[name] = max([err.get(name, 0)] + [
                _max_abs_diff(a, b) for a, b in outs])
            return got

        return call

    return Steps(*(pair(n) for n in Steps._fields))


def graph_walk(meta, kmeta, graphs: list, packed: list, lens: list,
               nh3: list, mesh, steps: Steps | None = None,
               stats: dict | None = None):
    """Walk every local shard's reads against the sharded graph.

    graphs, packed [b, ceil(L/16)] int32, lens [b] int32 and nh3 [b, P, 3]
    hold one entry per shard this process holds (graphs: its block, with
    .node_rows [Nb, ROW] and flat .pools [R] int32).  Returns one
    (MapResult, classes [b, max_nodes] int32) per local shard: classes are
    the pushed class ids, -1 in empty slots (the bitset intersection's
    input: the replicated node_row is a placeholder in this mode).

    `steps` defaults to the kernels for CUDA tensors and the plain steps
    for CPU tensors.  `stats`, when given, accumulates the loops'
    iterations, the fetches, all_to_alls and liveness all_reduces."""
    if steps is None:
        steps = kernel_steps() if packed[0].is_cuda else PLAIN_STEPS
    S, M, ww = kmeta.n_shards, meta.max_nodes, window_words(meta)
    shards = list(zip(mesh.ranks, graphs))
    count = stats if stats is not None else {}
    for key in ("walks", "left_iters", "forward_iters", "fetches",
                "all_to_alls", "syncs"):
        count.setdefault(key, 0)
    count["walks"] += 1

    def empty(shape):
        """One int32 buffer per local shard; -1 in shape stands for b."""
        return [torch.empty([p.shape[0] if n < 0 else n for n in shape],
                            dtype=torch.int32, device=p.device)
                for p in packed]

    st, buf = empty((-1, NSTATE)), empty((-1, M, 2))
    req_l, req_f = empty((S, -1, 2)), empty((S, -1, 2))
    for i in range(len(packed)):
        steps.init(meta, kmeta, nh3[i], lens[i], st[i], buf[i], req_l[i],
                   req_f[i])

    def fetch(reqs, width):
        count["fetches"] += 1
        count["all_to_alls"] += 2
        recv = mesh.all_to_all(reqs)
        resp = [steps.serve(kmeta, me, rv, g.node_rows, g.pools, width)
                for (me, g), rv in zip(shards, recv)]
        return mesh.all_to_all(resp)

    def alive(col) -> bool:
        count["syncs"] += 1
        flags = [s[:, col].any().to(torch.int32).reshape(1) for s in st]
        return int(mesh.all_reduce(flags)) > 0

    lcap, wcap = meta.max_left_iters, meta.max_walk_iters
    it = 0
    # the cap is read first: no liveness sync once it is reached
    while (lcap == 0 or it < lcap) and alive(L_ACT):
        back = fetch(req_l, ww)
        for i in range(len(packed)):
            steps.left_a(meta, kmeta, packed[i], back[i], st[i], req_l[i])
        back = fetch(req_l, 0)
        for i in range(len(packed)):
            steps.left_b(meta, kmeta, back[i], st[i], buf[i], req_l[i])
        it += 1
    count["left_iters"] += it
    it = 0
    while (wcap == 0 or it < wcap) and alive(F_ACT):
        back = fetch(req_f, ww)
        for i in range(len(packed)):
            steps.forward(meta, kmeta, packed[i], lens[i], nh3[i], back[i],
                          st[i], buf[i], req_f[i])
        it += 1
    count["forward_iters"] += it
    return [(steps.finish(meta, kmeta, s, b), b[:, :, 1].contiguous())
            for s, b in zip(st, buf)]
