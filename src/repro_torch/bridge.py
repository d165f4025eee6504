"""Carry parameters and layer-wise values between the JAX package and the
port, as numpy arrays (no counterpart in ``repro``).

The JAX package keeps a model's layers in its ``Layerwise`` layout: an
irregular ``prefix`` (``"prefix_{i}"`` entries in a parameter tree, a list
elsewhere) followed by a ``period`` of layers stacked ``repeats`` times on
a leading axis (``period/l{j}/...``).  The port keeps one module (or list
entry) per layer, in layer order::

    layer index of prefix entry i          = i
    layer index of period l{j}, repeat r   = len(prefix) + r * len(period) + j

An enc-dec model's encoder (``encoder/period/l0/...`` stacked
``encoder.num_layers`` times, and ``encoder/final_norm``) is the port's
``encoder.layers.{r}`` and ``encoder.final_norm``.

:func:`from_jax_params` / :func:`from_jax_memcom` / :func:`from_jax_icae`
build port modules from the JAX pytrees (numpy leaves, e.g.
``jax.tree.map(np.asarray, params)``), :func:`load_params` from a
checkpoint of them in the JAX package's format; :func:`to_numpy` is their
inverse, bit for bit.  ICAE's adapters sit in a tree laid out as the
model's (``period/l{j}/attn/wq/{a,b}`` stacked), one adapter a port
layer.  :func:`layerwise_to_list`
and :func:`list_to_layerwise` convert layer-wise values (hiddens, O^i,
prefixes, caches).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core.icae import ICAE, VARIANTS
from repro_torch.core.lora import LoRA, init_lora
from repro_torch.core.memcom import MemCom
from repro_torch.models.transformer import Transformer, torch_dtype


def _layer_index(cfg: ModelConfig, j: int, r: int) -> int:
    return len(cfg.layout.prefix) + r * len(cfg.layout.period) + j


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{path}/{key}" if path else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            if sub is not None:
                yield from _flatten(sub, f"{path}/{i}" if path else str(i))
    else:
        yield path, np.asarray(tree)


def _set_path(tree: dict, path: str, leaf) -> None:
    keys = path.split("/")
    node = tree
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = leaf


def _to_tensor(x: np.ndarray, device, dtype) -> torch.Tensor:
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype)


def _transformer_names(cfg: ModelConfig, tree) -> Dict[str, np.ndarray]:
    """Port parameter name -> array, from a JAX transformer param tree."""
    out = {}
    for path, arr in _flatten(tree):
        head, _, rest = path.partition("/")
        if head.startswith("prefix_"):
            out[f"layers.{int(head[7:])}.{rest.replace('/', '.')}"] = arr
        elif head == "encoder" and rest.startswith("period/"):
            rest = rest.split("/", 2)[2]  # past "period/l0"
            for r in range(cfg.encoder.num_layers):
                out[f"encoder.layers.{r}.{rest.replace('/', '.')}"] = arr[r]
        elif head == "period":
            lj, _, rest = rest.partition("/")
            for r in range(cfg.layout.repeats):
                li = _layer_index(cfg, int(lj[1:]), r)
                out[f"layers.{li}.{rest.replace('/', '.')}"] = arr[r]
        else:
            out[path.replace("/", ".")] = arr
    return out


def _memcom_names(cfg: ModelConfig, tree) -> Dict[str, np.ndarray]:
    out = {}
    for stack in ("source", "memory_llm"):
        for name, arr in _transformer_names(cfg, tree[stack]).items():
            out[f"{stack}.{name}"] = arr
    out["mem_tokens"] = np.asarray(tree["mem_tokens"])
    memx = tree["memx"]
    for i, entry in enumerate(memx.get("prefix") or []):
        if entry is not None:
            for path, arr in _flatten(entry["memx"]):
                out[f"memx.{i}.{path.replace('/', '.')}"] = arr
    for lj, entry in (memx.get("period") or {}).items():
        for path, arr in _flatten(entry["memx"]):
            for r in range(cfg.layout.repeats):
                li = _layer_index(cfg, int(lj[1:]), r)
                out[f"memx.{li}.{path.replace('/', '.')}"] = arr[r]
    return out


def _layer_path(cfg: ModelConfig, li: int) -> Tuple[bool, str]:
    """(in the prefix?, "prefix_{i}" / "period/l{j}") of port layer ``li``."""
    n_pre = len(cfg.layout.prefix)
    if li < n_pre:
        return True, f"prefix_{li}"
    return False, f"period/l{(li - n_pre) % len(cfg.layout.period)}"


def jax_path(cfg: ModelConfig, kind: str, name: str) -> str:
    """The JAX parameter path (``repro.utils.pytree.tree_flatten_with_names``
    form) of port parameter ``name`` of a ``kind`` = "transformer",
    "memcom" or "icae" module.  Layers of one ``period`` entry share a
    path (the JAX tree stacks them)."""
    if kind == "icae":
        head, _, rest = name.partition(".")
        if head in ("compressor", "lora"):
            return f"{head}/{jax_path(cfg, 'transformer', rest)}"
        return name.replace(".", "/")
    if kind == "memcom":
        head, _, rest = name.partition(".")
        if head in ("source", "memory_llm"):
            return f"{head}/{jax_path(cfg, 'transformer', rest)}"
        if head == "memx":
            li, _, rest = rest.partition(".")
            in_prefix, where = _layer_path(cfg, int(li))
            where = f"prefix/{li}" if in_prefix else where
            return f"memx/{where}/memx/{rest.replace('.', '/')}"
        return name.replace(".", "/")
    head, _, rest = name.partition(".")
    if head == "layers":
        li, _, rest = rest.partition(".")
        return f"{_layer_path(cfg, int(li))[1]}/{rest.replace('.', '/')}"
    if name.startswith("encoder.layers."):
        rest = name.split(".", 3)[3]
        return f"encoder/period/l0/{rest.replace('.', '/')}"
    return name.replace(".", "/")


@torch.no_grad()
def _load(module: torch.nn.Module, names: Dict[str, np.ndarray]):
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(names))
    extra = sorted(set(names) - set(params))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for name, p in params.items():
        arr = names[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(_to_tensor(arr, p.device, p.dtype))
    return module


def from_jax_params(cfg: ModelConfig, tree, *, device=None,
                    dtype=None) -> Transformer:
    """A port Transformer holding the JAX transformer params ``tree``."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device, dtype=torch_dtype(cfg, dtype))
    return _load(model, _transformer_names(cfg, tree))


def from_jax_memcom(cfg: ModelConfig, tree, *, device=None,
                    dtype=None) -> MemCom:
    """A port MemCom holding the JAX compressor params ``tree``
    ({"source", "memory_llm", "memx", "mem_tokens"})."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=torch_dtype(cfg, dtype))
    mc = MemCom(cfg, Transformer(cfg, **kw), Transformer(cfg, **kw))
    return _load(mc, _memcom_names(cfg, tree))


def from_jax_icae(cfg: ModelConfig, tree, variant: str, *,
                  device=None) -> ICAE:
    """A port ICAE of ``variant`` holding the JAX ICAE params ``tree``
    ({"compressor", "lora", "mem_embed"}) in the config's type; the
    ``period/l{j}`` adapters are unstacked, one a layer."""
    device = resolve_device(device)
    comp = Transformer(cfg, device=device, dtype=torch_dtype(cfg))
    lora = init_lora(comp, VARIANTS[variant])
    ic = ICAE(cfg, comp, lora, variant)
    names = {f"compressor.{n}": a
             for n, a in _transformer_names(cfg, tree["compressor"]).items()}
    names.update((f"lora.{n}", a)
                 for n, a in _transformer_names(cfg, tree["lora"]).items())
    names["mem_embed"] = np.asarray(tree["mem_embed"])
    return _load(ic, names)


def load_params(cfg: ModelConfig, path: str, *, device=None,
                dtype=None) -> Tuple[Transformer, dict]:
    """(a port Transformer, the checkpoint's meta) from a directory of
    transformer params saved by either package's ``save_tree``."""
    from repro_torch.checkpoint.store import load_tree

    flat, meta = load_tree(path)
    tree = {}
    for name, t in flat.items():
        _set_path(tree, name, (t.float() if t.dtype == torch.bfloat16
                               else t).numpy())
    return from_jax_params(cfg, tree, device=device, dtype=dtype), meta


def _stack_layers(cfg: ModelConfig,
                  per_layer: Dict[int, Dict[str, np.ndarray]]) -> dict:
    """Per-layer {path: array} dicts -> {"prefix_i"/"period"} trees."""
    tree = {}
    n_pre = len(cfg.layout.prefix)
    for i in range(n_pre):
        for path, arr in per_layer.get(i, {}).items():
            _set_path(tree, f"prefix_{i}/{path}", arr)
    for j in range(len(cfg.layout.period)):
        rows = [per_layer.get(_layer_index(cfg, j, r), {})
                for r in range(cfg.layout.repeats)]
        for path in rows[0]:
            _set_path(tree, f"period/l{j}/{path}",
                      np.stack([row[path] for row in rows]))
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _transformer_tree(cfg: ModelConfig, model: Transformer) -> dict:
    tree, per_layer, encoder = {}, {}, {}
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, li, rest = name.split(".", 2)
            per_layer.setdefault(int(li), {})[rest.replace(".", "/")] = _numpy(p)
        elif name.startswith("encoder.layers."):
            _, _, r, rest = name.split(".", 3)
            encoder.setdefault(rest.replace(".", "/"), {})[int(r)] = _numpy(p)
        else:
            _set_path(tree, name.replace(".", "/"), _numpy(p))
    for path, rows in encoder.items():
        _set_path(tree, f"encoder/period/l0/{path}",
                  np.stack([rows[r] for r in range(len(rows))]))
    tree.update(_stack_layers(cfg, per_layer))
    return tree


def _lora_tree(cfg: ModelConfig, lora: LoRA) -> dict:
    per_layer = {}
    for name, p in lora.named_parameters():
        _, li, rest = name.split(".", 2)
        per_layer.setdefault(int(li), {})[rest.replace(".", "/")] = _numpy(p)
    return _stack_layers(cfg, per_layer)


def to_numpy(module) -> dict:
    """The JAX pytree (numpy leaves) of a port Transformer, MemCom or ICAE
    — the inverse of :func:`from_jax_params` / :func:`from_jax_memcom` /
    :func:`from_jax_icae`.  bfloat16 parameters come back as float32
    (exactly)."""
    cfg = module.cfg
    if isinstance(module, Transformer):
        return _transformer_tree(cfg, module)
    if isinstance(module, ICAE):
        return {"compressor": _transformer_tree(cfg, module.compressor),
                "lora": _lora_tree(cfg, module.lora),
                "mem_embed": _numpy(module.mem_embed)}
    if not isinstance(module, MemCom):
        raise TypeError(f"expected Transformer, MemCom or ICAE, got "
                        f"{type(module)}")
    per_layer = {}
    for name, p in module.memx.named_parameters():
        li, rest = name.split(".", 1)
        per_layer.setdefault(int(li), {})[f"memx/{rest.replace('.', '/')}"] = \
            _numpy(p)
    stacked = _stack_layers(cfg, per_layer)
    memx = {}
    if cfg.layout.prefix:
        memx["prefix"] = [stacked.get(f"prefix_{i}")
                          for i in range(len(cfg.layout.prefix))]
    if "period" in stacked:
        memx["period"] = stacked["period"]
    return {"source": _transformer_tree(cfg, module.source),
            "memory_llm": _transformer_tree(cfg, module.memory_llm),
            "memx": memx, "mem_tokens": _numpy(module.mem_tokens)}


# ---------------------------------------------------------------------------
# Layer-wise values
# ---------------------------------------------------------------------------


def layerwise_to_list(cfg: ModelConfig, lw) -> list:
    """A JAX Layerwise value ({"prefix": [...], "period": {"l{j}": stacked}})
    -> a per-layer list (numpy leaves; dict entries stay dicts)."""
    def take(x, r):
        if isinstance(x, dict):
            return {k: take(v, r) for k, v in x.items()}
        return np.asarray(x)[r]

    def as_np(x):
        if isinstance(x, dict):
            return {k: as_np(v) for k, v in x.items()}
        return np.asarray(x)

    out = [None] * cfg.num_layers
    for i, entry in enumerate(lw.get("prefix") or []):
        out[i] = as_np(entry)
    for lj, entry in (lw.get("period") or {}).items():
        for r in range(cfg.layout.repeats):
            out[_layer_index(cfg, int(lj[1:]), r)] = take(entry, r)
    return out


def list_to_layerwise(cfg: ModelConfig, values: list) -> dict:
    """Inverse of :func:`layerwise_to_list` (numpy leaves)."""
    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: stack([x[k] for x in xs]) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    out = {}
    n_pre = len(cfg.layout.prefix)
    if n_pre:
        out["prefix"] = list(values[:n_pre])
    if cfg.layout.repeats:
        out["period"] = {
            f"l{j}": stack([values[_layer_index(cfg, j, r)]
                            for r in range(cfg.layout.repeats)])
            for j in range(len(cfg.layout.period))}
    return out
