"""Plan / info serialization — amortize inspection cost across runs.

The reference's persistent state is in-memory only (operation_info_t
handles, matrix_opt caches — SURVEY.md §5.4); here every plan is a
registered-dataclass pytree of arrays + static metadata, so it round-trips
through one ``.npz`` file: partition maps, level schedules, ELL geometry,
SpGEMM gather maps can be computed once and reloaded by later jobs.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np


def _to_jsonable(v):
    if isinstance(v, tuple):
        return {"__tuple__": [_to_jsonable(x) for x in v]}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _from_jsonable(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_from_jsonable(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def _collect(plan, prefix, arrays, static, classes, tuples):
    cls = type(plan)
    classes[prefix or "."] = f"{cls.__module__}:{cls.__qualname__}"
    for f in dataclasses.fields(cls):
        v = getattr(plan, f.name)
        key = f"{prefix}{f.name}"
        if f.metadata.get("static"):
            static[key] = _to_jsonable(v)
        elif v is None:
            pass  # omitted -> dataclass default (None) on reload
        elif dataclasses.is_dataclass(v):
            _collect(v, key + "/", arrays, static, classes,
                     tuples)                            # nested plan
        elif isinstance(v, tuple):
            # tuple of bucket arrays (SellPlan.buckets,
            # DistSellPlan.bucket_values): one '/i' entry per element
            tuples[key] = len(v)
            for i, x in enumerate(v):
                sub = f"{key}/{i}"
                if dataclasses.is_dataclass(x):
                    _collect(x, sub + "/", arrays, static, classes,
                             tuples)
                else:
                    arrays[sub] = np.asarray(x)
        else:
            arrays[key] = np.asarray(v)


def save_plan(path: str, plan) -> None:
    """Persist any registered-dataclass plan (SpgemmPlan, TrsvPlan,
    EllPlan, DiaPlan, SellPlan, DistSpgemmPlan, ...) to ``path``
    (.npz).  Nested plan dataclasses are flattened with '/'-joined
    keys."""
    if not dataclasses.is_dataclass(plan):
        raise TypeError(f"not a dataclass plan: {type(plan)!r}")
    arrays, static, classes, tuples = {}, {}, {}, {}
    _collect(plan, "", arrays, static, classes, tuples)
    np.savez(path,
             __classes__=np.str_(json.dumps(classes)),
             __static__=np.str_(json.dumps(static)),
             __tuples__=np.str_(json.dumps(tuples)),
             **arrays)


def _resolve(qualname: str):
    mod_name, _, qual = qualname.partition(":")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _rebuild(prefix, z, classes, static, tuples):
    cls = _resolve(classes[prefix or "."])
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        if f.metadata.get("static"):
            # static fields added after a plan was saved fall back to
            # the dataclass default
            if key in static:
                kwargs[f.name] = _from_jsonable(static[key])
        elif key in tuples:
            items = []
            for i in range(tuples[key]):
                sub = f"{key}/{i}"
                if (sub + "/") in classes:
                    items.append(_rebuild(sub + "/", z, classes,
                                          static, tuples))
                else:
                    items.append(jnp.asarray(z[sub]))
            kwargs[f.name] = tuple(items)
        elif any(c.startswith(key + "/") for c in classes):
            kwargs[f.name] = _rebuild(key + "/", z, classes, static,
                                      tuples)
        elif key in z.files:
            kwargs[f.name] = jnp.asarray(z[key])
        else:
            # _collect omits None-valued fields, so absence means the
            # saved value WAS None — reconstruct it explicitly (fields
            # without a default would otherwise make cls(**kwargs)
            # raise TypeError)
            kwargs[f.name] = None
    return cls(**kwargs)


def load_plan(path: str):
    """Reload a plan saved by :func:`save_plan`; arrays come back as
    device arrays ready for the jitted execute phase."""
    with np.load(path, allow_pickle=False) as z:
        if "__classes__" in z.files:
            classes = json.loads(str(z["__classes__"]))
            static = json.loads(str(z["__static__"]))
            tuples = (json.loads(str(z["__tuples__"]))
                      if "__tuples__" in z.files else {})
            return _rebuild("", z, classes, static, tuples)
        # legacy single-level format
        mod_name, _, qual = str(z["__class__"]).partition(":")
        cls = _resolve(f"{mod_name}:{qual}")
        static = {k: _from_jsonable(v)
                  for k, v in json.loads(str(z["__static__"])).items()}
        kwargs = dict(static)
        for f in dataclasses.fields(cls):
            if f.name in z.files:
                kwargs[f.name] = jnp.asarray(z[f.name])
        return cls(**kwargs)
