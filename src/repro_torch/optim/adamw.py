"""AdamW with an f32 master copy, ported from ``repro.optim.adamw``.

Functional, as the reference: ``state = opt.init(params)``, ``params,
state = opt.update(grads, state, params)`` returns new tensors and leaves
its arguments as they were.  :meth:`AdamW.update_` writes the same values
leaf by leaf into the state and the parameters in place, so a step holds
one leaf's temporaries instead of a second copy of the parameters and
moments; the train step uses it, and ``update`` is ``update_`` on copies.  ``params`` is a module
(its named parameters) or a ``{name: tensor}`` mapping; ``grads``,
``m``, ``v`` and ``master`` are ``{name: tensor}``.  m / v are always f32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim._tree import clone, named


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    master_weights: bool = True

    def init(self, params):
        ps = named(params)
        dev = next(iter(ps.values())).device
        state = {
            "m": {n: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for n, p in ps.items()},
            "v": {n: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for n, p in ps.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.master_weights:
            # a copy: the master never aliases the parameters
            state["master"] = {n: p.detach().to(torch.float32, copy=True)
                               for n, p in ps.items()}
        return state

    def _corrections(self, count):
        c = count + 1
        cf = c.to(torch.float32)
        # b ** count in f32, as the reference forms it
        return c, 1.0 - torch.pow(self.b1, cf), 1.0 - torch.pow(self.b2, cf)

    def _leaf(self, g, m, v, p, b1c, b2c, lr_scale):
        g = g.to(torch.float32)
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
        pf = p.to(torch.float32)
        pf = pf - self.lr * lr_scale * (step + self.weight_decay * pf)
        return m, v, pf

    def update(self, grads, state, params, lr_scale=1.0):
        """Returns (new params ``{name: tensor}``, new state):
        :meth:`update_` on copies, so the arguments stay as they were."""
        new_p = {n: p.detach().clone() for n, p in named(params).items()}
        return self.update_(grads, clone(state), new_p, lr_scale)

    def update_(self, grads, state, params, lr_scale=1.0):
        """The update written in place, leaf by leaf, into ``state`` and
        ``params`` (under ``torch.no_grad()``).  Returns (params, state)."""
        ps = named(params)
        c, b1c, b2c = self._corrections(state["count"])
        masters = state.get("master", ps)
        with torch.no_grad():
            for n, p in ps.items():
                m, v, pf = self._leaf(grads[n], state["m"][n],
                                      state["v"][n], masters[n], b1c, b2c,
                                      lr_scale)
                state["m"][n].copy_(m)
                state["v"][n].copy_(v)
                if self.master_weights:
                    state["master"][n].copy_(pf)
                p.copy_(pf.to(p.dtype))
                del m, v, pf
            state["count"].copy_(c)
        return params, state
