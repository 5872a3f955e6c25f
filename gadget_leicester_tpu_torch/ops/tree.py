"""Barnes-Hut octree gravity [G2: forcetree.c :: force_treebuild() /
force_treeevaluate()] as batched array programs.

Counterpart of ``gadget_leicester_tpu/ops/tree.py:55-412`` (``morton_keys``,
``Octree``, ``build_octree``, ``tree_gravity``, ``_eval_monopole``,
``_eval_pointset``). Plain PyTorch, as the reference is plain ``jnp``: it
has no kernel there, so none is written here. The algorithm is kept, so
that the two can be compared:

* **Build**: 30-bit Morton keys (depth <= 10), one global STABLE sort
  (``jnp.argsort`` is stable, and the frontier's order follows it); every
  level is a segmented reduction over the sorted particles (``index_add_``
  / ``scatter_reduce_`` for ``jax.ops.segment_sum`` / ``segment_max`` /
  ``segment_min``): mass, centre of mass and largest softening per node;
  child links are ``searchsorted`` ranges over the next level's sorted
  prefixes.
* **Traversal**: targets in Morton-contiguous blocks of ``block``; a
  per-block frontier of ``frontier_cap`` candidate nodes walks down the
  levels. Nodes that pass the block-level opening test (geometric, or the
  relative criterion M s^4 > alpha |a_old| d^6, each with the containment
  guard) act as monopoles on every target of the block; the others put
  their children into the next frontier, in order. At the last level the
  surviving nodes are leaf buckets of up to ``bucket_cap`` particles,
  evaluated directly, plus the exact residual monopole of a bucket's
  tail.

Where the reference maps one block at a time with ``lax.map``, a chunk of
``block_chunk`` blocks is a leading dimension here and the host loops over
chunks. The leaf buckets, which the reference evaluates as ``frontier_cap x
bucket_cap`` mostly empty slots per block, are compacted to the slots that
hold a particle, in the same order: the same sums up to their order in
float32. The compacted width is the one number the host reads in a force
computation. As in the reference, no overflow flag comes back.

Two faults of the reference are not carried over (ROADMAP queue 3):

* **A full frontier.** The reference accepts a parent whose children do
  not fit the frontier as a monopole, although the opening test said that
  its cell may hold targets of the block: a target then feels its own
  cell's mass from that cell's centre. A block of the sparse outskirts
  spans the dense centre and opens everything, so at the stock 20,000
  particles of the galaxy and cluster workloads the 2,048-node frontier
  fills for such blocks: 7% of the particles get force errors above 10%,
  and momentum drifts. Here the particles of such a parent (a contiguous
  range of the sorted array) are summed directly, with the leaf buckets:
  exact, no mass dropped, no extra host read. While no frontier fills,
  the two packages compute the same sums.
* **The residual monopole's centre.** A last-level node without a residual
  divides its mass moment by the 1e-37 floor, which overflows float32 once
  mass times position exceeds ~30, and the masked 0 x inf is NaN (every
  force of the stock cluster ICs); here such a node keeps its own centre
  of mass.

Boundaries: vacuum, or periodic without PM through the tabulated Ewald
correction (``ops/ewald.py``) on every accepted interaction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from gadget_leicester_tpu_torch.ops.softening import grav_fac, grav_pot

BIGKEY = 2 ** 30   # beyond any valid 30-bit key: dead particles sort last


def _part1by2(x):
    """Spread 10 bits of x over 30."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(pos, origin, extent, depth: int) -> torch.Tensor:
    """30-bit Morton keys at ``depth`` levels (depth <= 10), left-aligned
    so that prefixes nest at 10 levels; int32."""
    assert 1 <= depth <= 10, f"octree depth {depth} out of range (max 10)"
    scale = (1 << depth) / extent
    c = ((pos - origin) * scale).to(torch.int32).clamp(0, (1 << depth) - 1)
    key = (_part1by2(c[:, 0]) << 2) | (_part1by2(c[:, 1]) << 1) \
        | _part1by2(c[:, 2])
    return key << (3 * (10 - depth))


@dataclass
class Octree:
    """Per-level node arrays (tuples indexed by level - 1; level 0 is the
    trivial root) and the Morton-sorted particle arrays."""

    depth: int
    n_alloc: Tuple[int, ...]
    mass: Tuple[torch.Tensor, ...]      # [M_L]
    com: Tuple[torch.Tensor, ...]       # [M_L, 3]
    maxsoft: Tuple[torch.Tensor, ...]
    pfx: Tuple[torch.Tensor, ...]       # [M_L] sorted prefixes (pad BIGKEY)
    child_lo: Tuple[torch.Tensor, ...]  # [M_L] first child index at L + 1
    child_hi: Tuple[torch.Tensor, ...]
    pstart: Tuple[torch.Tensor, ...]    # [M_L] first particle (sorted order)
    pcount: Tuple[torch.Tensor, ...]
    pos_s: torch.Tensor
    mass_s: torch.Tensor
    soft_s: torch.Tensor
    alive_s: torch.Tensor
    order: torch.Tensor                 # sorted -> original index
    origin: torch.Tensor
    extent: torch.Tensor                # 0-d (cubic)


def build_octree(pos, mass, soft, alive, depth: int = 8) -> Octree:
    """[G2: force_treebuild() + force_update_node_recursive()] as one sort
    and per-level segmented reductions."""
    n = pos.shape[0]
    dev = pos.device
    inf = torch.full_like(pos, float("inf"))
    lo = torch.where(alive[:, None], pos, inf).amin(0)
    hi = torch.where(alive[:, None], pos, -inf).amax(0)
    extent = (hi - lo).max() * 1.0001 + 1e-30
    origin = lo - 0.5 * (extent - (hi - lo))

    key = morton_keys(pos, origin, extent, depth)
    key = torch.where(alive, key, torch.full_like(key, BIGKEY))
    key_s, order = torch.sort(key, stable=True)
    pos_s = pos[order]
    mass_s = torch.where(alive, mass, torch.zeros_like(mass))[order]
    soft_s, alive_s = soft[order], alive[order]
    wpos = mass_s[:, None] * pos_s
    idx = torch.arange(n, device=dev)
    key_s = key_s.long()
    soft_live = torch.where(alive_s, soft_s, torch.zeros_like(soft_s))

    lv = {k: [] for k in ("mass", "com", "maxsoft", "pfx", "pstart",
                          "pcount")}
    n_alloc = []
    for lvl in range(1, depth + 1):
        pfx_s = key_s >> (3 * (10 - lvl))            # dead: BIGKEY >> shift
        alloc = min(n, 8 ** lvl) + 1
        n_alloc.append(alloc)
        newseg = torch.ones(n, dtype=torch.bool, device=dev)
        newseg[1:] = pfx_s[1:] != pfx_s[:-1]
        seg = (torch.cumsum(newseg, 0) - 1).clamp_max(alloc - 1)
        seg = torch.where(alive_s, seg, torch.full_like(seg, alloc - 1))
        m = torch.zeros(alloc, dtype=pos.dtype, device=dev).index_add_(
            0, seg, mass_s)
        cw = torch.zeros(alloc, 3, dtype=pos.dtype, device=dev).index_add_(
            0, seg, wpos)
        ms = torch.zeros(alloc, dtype=pos.dtype, device=dev).scatter_reduce_(
            0, seg, soft_live, reduce="amax")
        pfx_nodes = torch.full((alloc,), BIGKEY, dtype=torch.int64,
                               device=dev).scatter_reduce_(
            0, seg, torch.where(alive_s, pfx_s,
                                torch.full_like(pfx_s, BIGKEY)),
            reduce="amin")
        ps = torch.full((alloc,), n, dtype=torch.int64,
                        device=dev).scatter_reduce_(
            0, seg, torch.where(alive_s, idx, torch.full_like(idx, n)),
            reduce="amin")
        pc = torch.zeros(alloc, dtype=torch.int64, device=dev).index_add_(
            0, seg, alive_s.long())
        lv["mass"].append(m)
        lv["com"].append(cw / m.clamp_min(1e-37)[:, None])
        lv["maxsoft"].append(torch.where(m > 0, ms, torch.zeros_like(ms)))
        lv["pfx"].append(pfx_nodes)
        lv["pstart"].append(ps)
        lv["pcount"].append(pc)

    # children of node (level L, prefix p): the nodes at L + 1 whose
    # prefix >> 3 == p; both prefix arrays are sorted
    child_lo, child_hi = [], []
    for i in range(depth):
        p = lv["pfx"][i]
        if i + 1 < depth:
            nxt = lv["pfx"][i + 1]
            child_lo.append(torch.searchsorted(nxt, p << 3))
            child_hi.append(torch.searchsorted(nxt, (p + 1) << 3))
        else:
            child_lo.append(torch.zeros_like(p))
            child_hi.append(torch.zeros_like(p))

    return Octree(
        depth=depth, n_alloc=tuple(n_alloc), mass=tuple(lv["mass"]),
        com=tuple(lv["com"]), maxsoft=tuple(lv["maxsoft"]),
        pfx=tuple(lv["pfx"]), child_lo=tuple(child_lo),
        child_hi=tuple(child_hi), pstart=tuple(lv["pstart"]),
        pcount=tuple(lv["pcount"]), pos_s=pos_s, mass_s=mass_s,
        soft_s=soft_s, alive_s=alive_s, order=order, origin=origin,
        extent=extent)


def _pair_sums(dx, tsoft, ssoft, smass, pctx):
    """(acc [G, B, 3], pot [G, B]) of the softened pair terms of targets
    against sources at separations ``dx`` [G, B, S, 3] (target minus
    source) with source masses ``smass`` [G, S] (0 where masked);
    ``pctx = (box, table)`` takes the minimum image and adds the tabulated
    Ewald correction."""
    if pctx is not None:
        box, table = pctx
        dx = dx - box * torch.round(dx / box)
    r = torch.sqrt((dx * dx).sum(-1))
    h = torch.maximum(tsoft[:, :, None], ssoft[:, None, :])
    m = smass[:, None, :]
    acc = -torch.einsum("gbs,gbsc->gbc", m * grav_fac(r, h), dx)
    pot = (m * torch.where(r > 0, grav_pot(r, h),
                           torch.zeros_like(r))).sum(-1)
    if pctx is not None:
        from gadget_leicester_tpu_torch.ops.ewald import ewald_correction
        ca, cp = ewald_correction(dx, box, table)
        acc = acc + torch.einsum("gbs,gbsc->gbc", m.expand_as(r), ca)
        pot = pot + (m * cp).sum(-1)
    return acc, pot


def _eval_monopole(tpos, tsoft, node_com, node_mass, node_soft, valid,
                   pctx=None):
    """Softened monopoles of the nodes [G, F] on the targets [G, B] of
    each block: (acc [G, B, 3], pot [G, B]); nodes not ``valid`` add
    nothing."""
    dx = tpos[:, :, None, :] - node_com[:, None, :, :]
    m = torch.where(valid, node_mass, torch.zeros_like(node_mass))
    return _pair_sums(dx, tsoft, node_soft, m, pctx)


def _eval_pointset(tpos, tsoft, ppos, pmass, psoft, pctx=None):
    """Direct particle-particle sums of the leaf buckets [G, P] on the
    targets [G, B]."""
    dx = tpos[:, :, None, :] - ppos[:, None, :, :]
    return _pair_sums(dx, tsoft, psoft, pmass, pctx)


def _compact(counts, width: int):
    """For per-row item counts [G, F] (items of a row laid out item after
    item, row-major): the row index [G, width] and the offset within its
    item's run [G, width] of each of the first ``width`` slots, and which
    slots hold one [G, width]. Gathers only (a scatter would send every
    empty slot to one dump address)."""
    cum = torch.cumsum(counts, -1)
    s = torch.arange(width, device=counts.device).expand(counts.shape[0],
                                                         width)
    f = torch.searchsorted(cum, s.contiguous(), right=True)
    live = f < counts.shape[1]
    f = f.clamp_max(counts.shape[1] - 1)
    start = torch.gather(cum - counts, 1, f)
    return f, s - start, live


def tree_gravity(pos, mass, soft, alive, theta: float = 0.5, opening: int = 1,
                 err_tol_force_acc: float = 0.005, old_acc=None,
                 depth: int = 8, block: int = 256, frontier_cap: int = 2048,
                 bucket_cap: int = 48, periodic: bool = False,
                 box: float = 0.0, ewald_res: int = 32,
                 block_chunk: int = 16):
    """Barnes-Hut accelerations [N, 3] and potentials [N] (no G factor).

    opening = 0: the geometric criterion (s / d > theta); opening = 1: the
    relative criterion M s^4 > ErrTolForceAcc |a_old| d^6 [G2:
    force_treeevaluate()], the geometric one while ``old_acc`` is 0 (the
    first force computation), as the reference does. ``old_acc`` [N]
    carries no factor G. ``block_chunk`` blocks are traversed together."""
    n = pos.shape[0]
    f = pos.dtype
    dev = pos.device
    if periodic:
        from gadget_leicester_tpu_torch.ops.ewald import device_table
        pctx = (box, device_table(ewald_res, dev))
        pos = torch.remainder(pos, box)
    else:
        pctx = None
    tree = build_octree(pos, mass, soft, alive, depth=depth)
    nb = -(-n // block)
    npad = nb * block

    def blocks(x):
        pad = x.new_zeros((npad - n,) + x.shape[1:])
        return torch.cat([x, pad]).reshape((nb, block) + x.shape[1:])

    if old_acc is None:
        old_acc = torch.zeros(n, dtype=f, device=dev)
    oldacc_b = blocks(old_acc[tree.order])
    pos_b, soft_b, alive_b = blocks(tree.pos_s), blocks(tree.soft_s), \
        blocks(tree.alive_s)
    acc_b = torch.zeros(nb, block, 3, dtype=f, device=dev)
    pot_b = torch.zeros(nb, block, dtype=f, device=dev)
    leaf_ndx = torch.zeros(nb, frontier_cap, dtype=torch.int64, device=dev)
    leaf_open = torch.zeros(nb, frontier_cap, dtype=torch.bool, device=dev)
    # particle ranges of the parents a full frontier could not expand
    full_start = torch.zeros(nb, tree.depth - 1, frontier_cap,
                             dtype=torch.int64, device=dev)
    full_count = torch.zeros_like(full_start)

    # frontier at level 1: the nodes of level 1 that hold mass
    n1 = tree.n_alloc[0]
    first = torch.arange(frontier_cap, device=dev)
    first_c = first.clamp_max(n1 - 2)
    valid1 = (first < n1 - 1) & (tree.mass[0][first_c] > 0)
    fr1 = torch.where(valid1, first_c, torch.full_like(first, -1))
    inf = torch.full((), float("inf"), dtype=f, device=dev)

    for g0 in range(0, nb, block_chunk):
        sl = slice(g0, min(nb, g0 + block_chunk))
        tpos, tsoft, talive = pos_b[sl], soft_b[sl], alive_b[sl]
        g = tpos.shape[0]
        # block bounding sphere (alive targets only)
        c = torch.where(talive[..., None], tpos, torch.zeros_like(tpos)) \
            .sum(1) / talive.sum(1).clamp_min(1)[:, None]
        d2 = ((tpos - c[:, None, :]) ** 2).sum(-1)
        rb = torch.sqrt(torch.where(talive, d2, torch.zeros_like(d2))
                        .amax(1))
        min_oldacc = torch.where(talive, oldacc_b[sl], inf).amin(1)
        acc = torch.zeros(g, block, 3, dtype=f, device=dev)
        pot = torch.zeros(g, block, dtype=f, device=dev)
        fr = fr1.expand(g, frontier_cap)

        for lvl in range(1, tree.depth + 1):
            i = lvl - 1
            size = tree.extent / (1 << lvl)          # cell side at this level
            valid = fr >= 0
            ndx = fr.clamp_min(0)
            ncom = tree.com[i][ndx]
            nmass = torch.where(valid, tree.mass[i][ndx],
                                torch.zeros((), dtype=f, device=dev))
            nsoft = tree.maxsoft[i][ndx]
            dcv = ncom - c[:, None, :]
            if periodic:
                dcv = dcv - box * torch.round(dcv / box)
            d_com = torch.sqrt((dcv * dcv).sum(-1))
            d = (d_com - rb[:, None]).clamp_min(1e-30)   # least distance
            geo = size > theta * d
            if opening == 1:
                # relative criterion, geometric while a_old == 0
                rel = nmass * size ** 4 > err_tol_force_acc * \
                    min_oldacc.clamp_min(1e-37)[:, None] * d ** 6
                open_ = torch.where((min_oldacc > 0)[:, None], rel, geo)
            else:
                open_ = geo
            # containment guard: a node whose cell may hold a target must
            # open (the monopole of one's own cell is a self-force); its
            # centre of mass lies in the cell, so a contained target is
            # within sqrt(3) size of it
            open_ = open_ | (d < 1.7321 * size) | (d < nsoft)
            has = valid & (nmass > 0)
            accept = has & ~open_
            opened = has & open_
            if lvl < tree.depth:
                clo = tree.child_lo[i][ndx]
                chi = tree.child_hi[i][ndx]
                # parents whose children would not fit the frontier: their
                # particles are summed directly with the leaf buckets
                n_child = torch.where(opened, chi - clo,
                                      torch.zeros_like(clo))
                fits = opened & (torch.cumsum(n_child, -1) <= frontier_cap)
                full = opened & ~fits
                full_start[sl, i] = tree.pstart[i][ndx]
                full_count[sl, i] = torch.where(full, tree.pcount[i][ndx],
                                                torch.zeros_like(clo))
                # children of the fitting nodes, in order: next frontier
                node, off, live = _compact(
                    torch.where(fits, n_child, torch.zeros_like(n_child)),
                    frontier_cap)
                fr = torch.where(live, torch.gather(clo, 1, node) + off,
                                 torch.full_like(off, -1))
            a, pp = _eval_monopole(tpos, tsoft, ncom, nmass, nsoft, accept,
                                   pctx)
            acc, pot = acc + a, pot + pp
        acc_b[sl], pot_b[sl] = acc, pot
        leaf_ndx[sl], leaf_open[sl] = ndx, opened

    # leaf buckets: up to bucket_cap particles of each opened last-level
    # node directly, and the residual monopole of what a bucket left out;
    # before them in each block's list, the ranges a full frontier left
    i = tree.depth - 1
    pcnt = torch.where(leaf_open, tree.pcount[i][leaf_ndx],
                       torch.zeros_like(leaf_ndx)).clamp_max(bucket_cap)
    pstart = tree.pstart[i][leaf_ndx]
    counts = torch.cat([full_count.reshape(nb, -1), pcnt], 1)
    starts = torch.cat([full_start.reshape(nb, -1), pstart], 1)
    width = int(counts.sum(-1).max())     # the one host read
    # blocks per step of the direct sums: ~2^25 pairs at a time
    leaf_chunk = max(1, min(block_chunk, (1 << 25) // (block * max(width, 1))))
    slot = torch.arange(bucket_cap, device=dev)
    for g0 in range(0, nb, leaf_chunk):
        sl = slice(g0, min(nb, g0 + leaf_chunk))
        tpos, tsoft = pos_b[sl], soft_b[sl]
        ndx, opened = leaf_ndx[sl], leaf_open[sl]
        acc, pot = acc_b[sl], pot_b[sl]
        if width > 0:
            node, off, live = _compact(counts[sl], width)
            pidc = (torch.gather(starts[sl], 1, node) + off).clamp_max(n - 1)
            pmass = torch.where(live, tree.mass_s[pidc],
                                torch.zeros((), dtype=f, device=dev))
            a, pp = _eval_pointset(tpos, tsoft, tree.pos_s[pidc], pmass,
                                   tree.soft_s[pidc], pctx)
            acc, pot = acc + a, pot + pp
        # what each bucket evaluated, per node, in the reference's slots
        bidx = (pstart[sl][..., None] + slot).clamp_max(n - 1)
        bm = torch.where(slot < pcnt[sl][..., None], tree.mass_s[bidx],
                         torch.zeros((), dtype=f, device=dev))
        m_eval = bm.sum(-1)
        wx_eval = (bm[..., None] * tree.pos_s[bidx]).sum(-2)
        nm = tree.mass[i][ndx]
        m_res = torch.where(opened, nm - m_eval,
                            torch.zeros_like(nm)).clamp_min(0.0)
        has_res = m_res > 1e-37
        ncom = tree.com[i][ndx]
        # a node with no residual keeps its own centre: the quotient by
        # the 1e-37 floor overflows float32 where mass x position exceeds
        # ~30 (the reference's does, and its 0 x inf is NaN)
        com_res = torch.where(
            has_res[..., None],
            (nm[..., None] * ncom - wx_eval)
            / m_res.clamp_min(1e-37)[..., None], ncom)
        a, pp = _eval_monopole(tpos, tsoft, com_res, m_res,
                               tree.maxsoft[i][ndx], has_res, pctx)
        acc_b[sl], pot_b[sl] = acc + a, pot + pp

    acc_s = torch.where(alive_b[..., None], acc_b,
                        torch.zeros_like(acc_b)).reshape(npad, 3)[:n]
    pot_s = torch.where(alive_b, pot_b,
                        torch.zeros_like(pot_b)).reshape(npad)[:n]
    # back to the original particle order
    acc = torch.zeros_like(acc_s)
    pot = torch.zeros_like(pot_s)
    acc[tree.order] = acc_s
    pot[tree.order] = pot_s
    return acc, pot
