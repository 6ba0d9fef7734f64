"""Shared circuit gadgets + witness helpers for the graph operators.

PyTorch-port counterpart of ``repro.core.operators.common``; witnesses stay
host numpy arrays, as in the reference."""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .. import field as F
from .. import prover as pv
from .. import verifier as vf
from ..plonkish import Circuit, Col, Const, Expr


def host_inv(x: np.ndarray) -> np.ndarray:
    """Vectorized modular inverse on the host (witness side only); zero
    maps to zero."""
    arr = torch.from_numpy(np.asarray(x, np.int64) % F.P)
    return F.fbatch_inv(arr).numpy()


def eq_flag_gadget(c: Circuit, name: str, lhs: Expr, rhs: Expr, sel: Expr):
    """fl = 1 iff lhs == rhs on selected rows (standard inverse trick).

    Gates: fl boolean; sel*fl*(lhs-rhs)=0; sel*(1-fl)*((lhs-rhs)*inv - 1)=0.
    Returns (fl, inv) advice columns. Witness: use fill_eq_flag.
    """
    fl = c.add_advice(f"{name}/fl")
    inv = c.add_advice(f"{name}/inv")
    diff = lhs - rhs
    c.add_gate(f"{name}/bool", fl * (Const(1) - fl))
    c.add_gate(f"{name}/zero", sel * fl * diff)
    c.add_gate(f"{name}/nonzero", sel * (Const(1) - fl) * (diff * inv - Const(1)))
    return fl, inv


def fill_eq_flag(advice, fl: Col, inv: Col, lhs_vals, rhs_vals, sel_vals):
    lhs = np.asarray(lhs_vals, np.int64) % F.P
    rhs = np.asarray(rhs_vals, np.int64) % F.P
    sel = np.asarray(sel_vals, np.int64)
    eq = (lhs == rhs) & (sel != 0)
    advice[fl.index] = eq.astype(np.uint32)
    diff = (lhs - rhs) % F.P
    invv = host_inv(diff)
    advice[inv.index] = np.where((sel != 0) & ~eq, invv, 0).astype(np.uint32)


def region_selector(c: Circuit, name: str, length: int) -> Col:
    vals = np.zeros(c.n_rows, np.uint32)
    vals[:length] = 1
    return c.add_fixed(name, vals)


def pad_col(vals, n: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    v = np.asarray(vals, np.int64)
    out[: len(v)] = v
    return out % F.P


@dataclass
class Operator:
    """A compiled operator: circuit + keys + the filled column layout."""
    name: str
    circuit: Circuit
    keys: pv.Keys = None
    handles: dict = dc_field(default_factory=dict)

    def keygen(self, cfg: pv.ProverConfig = None):
        self.keys = pv.keygen(self.circuit, cfg or pv.ProverConfig())
        return self

    def new_advice(self):
        return np.zeros((self.circuit.n_advice, self.circuit.n_rows), np.uint32)

    def new_instance(self):
        return np.zeros((self.circuit.n_instance, self.circuit.n_rows), np.uint32)

    def new_data(self):
        return np.zeros((self.circuit.n_data, self.circuit.n_rows), np.uint32)

    def prove(self, advice, instance, data=None):
        assert self.keys is not None, "call keygen() first"
        return pv.prove(self.keys, advice, instance, data, label=self.name)

    def verify(self, instance, proof, expected_data_root=None) -> bool:
        return vf.verify(self.keys, instance, proof, expected_data_root,
                         label=self.name)
