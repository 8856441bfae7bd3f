"""Adafactor (factored second moments), ported from
``repro.optim.adafactor``: O(rows + cols) state for a matrix.

The reference applies it to the unit-stacked parameter pytree, and the
stacking changes the arithmetic: a stacked norm scale ``(n_units, d)`` is
factored (``ndim >= 2``) across its units, and the RMS update clip is
taken over a unit position's whole stack.  The port's parameters are per
layer, so the optimizer works on the decoder's ``param_groups()``: each
group's tensors are stacked into the reference's leaf, updated as one, and
written back.  The state keeps the reference's stacked shapes, keyed by
group (``units.{i}.{rest}`` or a parameter's own name).

``update_`` writes the new values into the state and the parameters in
place (under ``torch.no_grad()``); ``update``, functional, is ``update_``
on copies.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim._tree import clone, gather, groups, named, scatter


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def _factored(self, p):
        return p.dim() >= 2

    def init(self, params):
        ps = named(params)
        stats = {}
        for key, (names, stacked) in groups(params).items():
            shape = ((len(names),) if stacked else ()) + tuple(
                ps[names[0]].shape)
            dev = ps[names[0]].device
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
            if len(shape) >= 2:
                stats[key] = {"vr": zeros(shape[:-1]),
                              "vc": zeros(shape[:-2] + shape[-1:])}
            else:
                stats[key] = {"v": zeros(shape)}
        dev = next(iter(ps.values())).device
        return {"stats": stats,
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def _leaf(self, g, st, p, beta, lr_scale):
        g = g.to(torch.float32)
        g2 = g * g + self.eps
        if self._factored(p):
            vr = beta * st["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * st["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=self.eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            step = g / torch.sqrt(vhat + self.eps)
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            step = g / torch.sqrt(v + self.eps)
            new_st = {"v": v}
        # update clipping (Adafactor's RMS rule), over the whole leaf
        rms = torch.sqrt(torch.mean(step * step) + self.eps)
        step = step / torch.clamp(rms / self.clip_threshold, min=1.0)
        pf = p.to(torch.float32) - self.lr * lr_scale * step
        return pf.to(p.dtype), new_st

    def update(self, grads, state, params, lr_scale=1.0):
        """Returns (new params ``{name: tensor}``, new state):
        :meth:`update_` on copies, grouped as ``params`` is, so the
        arguments stay as they were."""
        new_p = {n: p.detach().clone() for n, p in named(params).items()}
        new_state = clone(state)
        self._apply(grads, new_state, new_p, groups(params), lr_scale)
        return new_p, new_state

    def update_(self, grads, state, params, lr_scale=1.0):
        """The update written in place into ``state`` and ``params``
        (under ``torch.no_grad()``).  Returns (params, state)."""
        self._apply(grads, state, named(params), groups(params), lr_scale)
        return params, state

    def _apply(self, grads, state, ps, grouped, lr_scale):
        """Each group's leaf computed from ``ps``, one at a time, and
        written back into ``ps`` and ``state``."""
        with torch.no_grad():
            c = state["count"] + 1
            beta = 1.0 - torch.pow(c.to(torch.float32), -self.decay)
            for key, (names, stacked) in grouped.items():
                value, st = self._leaf(
                    gather(grads, names, stacked), state["stats"][key],
                    gather(ps, names, stacked), beta, lr_scale)
                for n, t in scatter(value, names, stacked).items():
                    ps[n].copy_(t)
                for k, t in st.items():
                    state["stats"][key][k].copy_(t)
            state["count"].copy_(c)
