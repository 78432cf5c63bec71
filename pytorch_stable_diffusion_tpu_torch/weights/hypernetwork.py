"""A1111 hypernetworks (port of ``weights/hypernetwork.py``): small
residual MLPs transforming the cross-attention context separately for the
k and v projections.

The ``.pt`` file maps each context width (int key, e.g. 768) to a pair of
``HypernetworkModule`` state dicts (k-net, v-net), each a ``linear.*``
Sequential of Linear (and optionally LayerNorm) modules, applied as
``x + net(x) * strength``.  Inside cross-attention ``k = to_k(k_net(ctx))``
and ``v = to_v(v_net(ctx))``: the pipeline passes the ``(ctx_k, ctx_v)``
pair through the UNet to ``ops/attention.apply``.

The port keeps the nets in torch layout ((out, in) weights, fp32) in a
:class:`Hypernetwork` module, which rides in ``models["hypernetwork"]``
and moves to the request's device with the other models.  Files load
through the restricted torch unpickler (``ckpt_reader.load_torch_object``:
no pickle code execution).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: activation_func values A1111 offers at hypernetwork creation: the JAX
#: package's table (its "gelu" is jax.nn.gelu's tanh form)
ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leakyrelu": F.leaky_relu,
    "elu": F.elu,
    "swish": F.silu,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
}

_META_KEYS = ("step", "name", "layer_structure", "activation_func",
              "is_layer_norm", "add_layer_norm", "use_dropout",
              "activate_output", "last_layer_dropout", "weight_initialization",
              "sd_checkpoint", "sd_checkpoint_name", "optional_info",
              "dropout_structure", "optimizer_name", "optimizer_state_dict")

Layer = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (weight, bias)


class Net(nn.ModuleList):
    """One HypernetworkModule: its Linear and LayerNorm modules in
    application order (fp32)."""

    def __init__(self, layers: Sequence[Layer]):
        mods = []
        for w, b in layers:
            w = torch.as_tensor(w).float()
            if w.dim() == 2:
                m = nn.Linear(w.shape[1], w.shape[0], bias=b is not None, device="meta")
                m.weight = nn.Parameter(w.clone(), requires_grad=False)
                if b is not None:
                    m.bias = nn.Parameter(torch.as_tensor(b).float().clone(),
                                          requires_grad=False)
            elif w.dim() == 1:
                if b is None:
                    raise ValueError("a hypernetwork LayerNorm has no bias")
                m = nn.LayerNorm(w.shape[0], device="meta")
                m.weight = nn.Parameter(w.clone(), requires_grad=False)
                m.bias = nn.Parameter(torch.as_tensor(b).float().clone(),
                                      requires_grad=False)
            else:
                raise ValueError(f"unexpected hypernetwork weight of {w.dim()} dims")
            mods.append(m)
        super().__init__(mods)


class Hypernetwork(nn.Module):
    """``nets[str(width)]["k"|"v"]``: the k- and v-nets for each context
    width the file has."""

    def __init__(self, nets: Dict[str, Tuple[Sequence[Layer], Sequence[Layer]]]):
        super().__init__()
        self.nets = nn.ModuleDict({str(width): nn.ModuleDict({"k": Net(k), "v": Net(v)})
                                   for width, (k, v) in nets.items()})

    def widths(self) -> List[str]:
        return sorted(self.nets.keys())


def _parse_module(sd) -> List[Layer]:
    """One HypernetworkModule state dict -> its (weight, bias) layers in
    order.  ``linear.{i}.weight`` 2-D is a Linear, 1-D a LayerNorm.
    Sequential indices of activation/dropout modules are parameterless, so
    index gaps are expected and the sort order alone fixes the order."""
    from .convert import as_tensor

    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("linear.")})
    if not idxs:
        raise ValueError("hypernetwork module has no linear.* keys")
    layers: List[Layer] = []
    for i in idxs:
        w = as_tensor(sd[f"linear.{i}.weight"]).float()
        b = sd.get(f"linear.{i}.bias")
        b = None if b is None else as_tensor(b).float()
        if w.dim() == 1 and b is None:
            raise ValueError(f"LayerNorm linear.{i} missing bias")
        if w.dim() not in (1, 2):
            raise ValueError(f"unexpected linear.{i}.weight ndim {w.dim()}")
        layers.append((w, b))
    return layers


def load_hypernetwork(obj_or_path) -> Tuple[Hypernetwork, Tuple[str, bool]]:
    """Load an A1111 hypernetwork ``.pt`` (path or the already-unpickled
    dict) -> ``(hypernetwork, (activation, activate_output))``; the pair is
    what ``generate(hypernetwork=...)`` takes, with the module in
    ``models["hypernetwork"]``."""
    obj = obj_or_path
    if isinstance(obj_or_path, str):
        from .ckpt_reader import load_torch_object

        obj = load_torch_object(obj_or_path)
    if not isinstance(obj, dict):
        raise ValueError("hypernetwork file did not unpickle to a dict")
    act = (obj.get("activation_func") or "linear").lower()
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported hypernetwork activation {act!r} "
                         f"(known: {sorted(ACTIVATIONS)})")
    activate_output = bool(obj.get("activate_output", False))
    nets = {}
    for key, val in obj.items():
        if isinstance(key, int):
            if not (isinstance(val, (tuple, list)) and len(val) == 2):
                raise ValueError(f"size {key}: expected (k_sd, v_sd) pair")
            nets[str(key)] = (_parse_module(dict(val[0])), _parse_module(dict(val[1])))
        elif key not in _META_KEYS:
            raise ValueError(f"unexpected hypernetwork key {key!r}")
    if not nets:
        raise ValueError("hypernetwork has no size entries")
    return Hypernetwork(nets), (act, activate_output)


def _run_module(net: Net, x: torch.Tensor, activation: str,
                activate_output: bool) -> torch.Tensor:
    """``x + net(x)`` with the activation applied after every Linear except
    (unless activate_output) the last — A1111's HypernetworkModule."""
    act = ACTIVATIONS[activation]
    h = x
    n_linear = sum(isinstance(m, nn.Linear) for m in net)
    seen = 0
    for m in net:
        if isinstance(m, nn.Linear):
            h = F.linear(h, m.weight, m.bias)
            seen += 1
            if seen < n_linear or activate_output:
                h = act(h)
        else:  # LayerNorm (add_layer_norm=True nets), as the JAX package writes it
            mu = h.mean(dim=-1, keepdim=True)
            var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
            h = (h - mu) * torch.rsqrt(var + 1e-5)
            h = h * m.weight + m.bias
    return x + h


def apply_hypernetwork(hyper: Hypernetwork, context: torch.Tensor,
                       strength: torch.Tensor, *, activation: str,
                       activate_output: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """context (..., D) -> (ctx_k, ctx_v), computed in fp32 and returned in
    the context's dtype; ``strength`` is a tensor on the context's device
    (A1111's multiplier scales the residual: ``x + net(x) * strength``)."""
    d = str(context.shape[-1])
    if d not in hyper.nets:
        raise ValueError(f"hypernetwork has no entry for context width {d} "
                         f"(has {hyper.widths()})")
    nets = hyper.nets[d]
    base = context.float()

    def run(net):
        full = _run_module(net, base, activation, activate_output)
        return (base + strength * (full - base)).to(context.dtype)

    return run(nets["k"]), run(nets["v"])
