"""The column-physics chain as the port's kernel wrapper lays out its
inputs and outputs (frozen copy of speedy_tpu_torch/models/physics/fused.py
at commit 8f72ba0, the plain chain only): ``fused_grid_physics`` runs
``grid_physics_core`` on every device, never a compiled kernel."""
from __future__ import annotations

import torch

from .surface import SurfaceFluxes

LAT_INPUTS = range(16, 23)  # the [il] fields and ablco2, always shared


def _inner_contiguous(x: torch.Tensor, rank: int) -> bool:
    """Whether the last ``rank`` dimensions of x (a member's slice) are
    laid out contiguously."""
    if x.is_contiguous():
        return True
    want = 1
    for n, st in zip(reversed(x.shape[x.dim() - rank:]),
                     reversed(x.stride()[x.dim() - rank:])):
        if n > 1 and st != want:
            return False
        want *= n
    return True


def _rows_contiguous(x: torch.Tensor, rank: int) -> torch.Tensor:
    """x with its last ``rank`` dimensions contiguous, copied only where
    they are not."""
    return x if _inner_contiguous(x, rank) else x.contiguous()


def kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg) -> list:
    """The kernel's inputs in its order: the lowest-level winds ug, vg as
    [..., il, ix] (the chain reads no other level of them), tg, qg, phig
    as [..., kx, il, ix], 11 x [..., il, ix], 6 x [il] (the [il, 1] fields
    and coa), ablco2 as [1]; on non-SW steps also tau2
    [..., 4, kx, il, ix], stratc [..., 2, il, ix], tt_rsw
    [..., kx, il, ix] and ssrd [..., il, ix]. The leading dimension, where
    a field has it, is an ensemble's member axis; each member's slice is
    contiguous."""
    ins = [pg.ug[..., -1, :, :], pg.vg[..., -1, :, :], pg.tg, pg.qg,
           pg.phig, pg.pslg, daily.albsfc, daily.alb_l, daily.alb_s,
           daily.snowc, daily.soilw_am, surf.stl_am, surf.sst_am,
           pp.forog, pp.phis0, pp.fmask_l,
           daily.fsol, daily.ozupp, daily.ozone, daily.zenit, daily.stratz,
           pp.coa, daily.ablco2]
    if not compute_sw:
        ins += [rad.tau2, rad.stratc, rad.tt_rsw, rad.ssrd]
    return [x.reshape(-1).contiguous() if i in LAT_INPUTS
            else _rows_contiguous(x, rank)
            for i, (x, rank) in enumerate(zip(ins, IN_RANKS))]


def output_shapes(kx: int, il: int, ix: int, compute_sw: bool,
                  members=None) -> list:
    """One model's output shapes, each led by ``members`` where given."""
    shapes = ([(kx, il, ix)] * 4          # utend vtend ttend qtend
              + [(il, ix)] * 6            # precnv precls cbmf slrd slr olr
              + [(3, il, ix)] * 5         # ustr vstr shf evap slru
              + [(2, il, ix)]             # hfluxn
              + [(il, ix)] * 5)           # tsfc tskin u0 v0 t0
    if compute_sw:
        shapes += [(4, kx, il, ix), (2, il, ix), (kx, il, ix),
                   (il, ix), (il, ix), (il, ix)]  # tau2 stratc tt_rsw ssrd ssr tsr
    return shapes if members is None else [(members,) + s for s in shapes]


def input_shapes(kx: int, il: int, ix: int, compute_sw: bool) -> list:
    """One model's input shapes (a member's, in an ensemble)."""
    shapes = ([(il, ix)] * 2 + [(kx, il, ix)] * 3 + [(il, ix)] * 11
              + [(il,)] * 6 + [(1,)])
    if not compute_sw:
        shapes += [(4, kx, il, ix), (2, il, ix), (kx, il, ix), (il, ix)]
    return shapes


IN_RANKS = tuple(len(s) for s in input_shapes(1, 1, 1, False))


def _unflatten(outs, compute_sw):
    sfc = SurfaceFluxes(*outs[10:21])
    base = tuple(outs[:10]) + (sfc,)
    return base + tuple(outs[21:]) if compute_sw else base


def members_of(ins: list):
    """The member count of kernel inputs (tg's leading axis), or None for
    one model's."""
    tg = ins[2]
    return tg.shape[0] if tg.dim() == 4 else None


def plain_outputs(cfg, pp, compute_sw: bool, ins: list) -> list:
    """The kernel's plain twin: grid_physics_core on the kernel's inputs
    (kernel_inputs order, with or without the member axis) in the LW order
    ``cfg`` picks, returning the flat list of outputs in the kernel's
    shapes. The lowest-level winds are broadcast over the levels: the
    chain reads only the lowest."""
    from . import grid_physics_core
    il, ix = ins[5].shape[-2:]       # pslg: a latitude band's rows, or all
    col = lambda x: x.reshape(il, 1)
    lev = lambda x: x.unsqueeze(-3).expand(*x.shape[:-2], cfg.kx, il, ix)
    a = ins
    outs = grid_physics_core(
        cfg, pp, compute_sw, lev(a[0]), lev(a[1]), a[2], a[3], a[4], a[5],
        col(a[16]), col(a[17]), col(a[18]), col(a[19]), col(a[20]), a[6],
        a[22].reshape(()), a[7], a[8], a[9], a[10], a[11], a[12],
        a[13], a[21], a[14], a[15],
        *((None,) * 4 if compute_sw else a[23:27]))
    outs = list(outs[:10]) + list(outs[10]) + list(outs[11:])
    shapes = output_shapes(cfg.kx, il, ix, compute_sw, members_of(ins))
    return [x if x.shape == s else x.expand(s) for x, s in zip(outs, shapes)]


def fused_grid_physics(cfg, pp, compute_sw, daily, surf, rad, pg):
    """The grid_physics_core call of get_physical_tendencies, for one model
    or all members of an ensemble in one call, on the plain chain."""
    ins = kernel_inputs(cfg, pp, compute_sw, daily, surf, rad, pg)
    return _unflatten(plain_outputs(cfg, pp, compute_sw, ins), compute_sw)
