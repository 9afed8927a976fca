"""Checkpoint and resume of sampler state (counterpart of
``mini_mcmc_tpu/checkpoint.py``).

A sampler's whole state (positions, cached densities and gradients, NUTS's
dual averaging, tempering's replicas, the SG-MCMC step count) is a
NamedTuple of tensors and host ints, and every draw of a ``run()`` derives
from the sampler's CPU ``torch.Generator``. So a checkpoint is those
fields and that generator's state, and a sampler restored from it
continues bit for bit as the saved one would have.

Format: one file, ``<path>.pt``, written by ``torch.save`` and read by
``torch.load(weights_only=True)``. It holds a plain dict: the format's
name and version, the state type's name, the fields by name (tensors on
the CPU; host ints stay ints), the generator state and ``extra``, the
records of the sampler's metric and transform that :func:`restore_sampler`
checks. Nothing is pickled: the state is rebuilt from a registry of this
package's state types.

The JAX package's formats (an orbax directory or an ``.npz`` beside a
pickled treedef) are not read or written here. A checkpoint loads on any
device: ``load_checkpoint(path, device=...)`` places the state, and
:func:`restore_sampler` moves each field to the restoring sampler's
device and dtype, so a state saved on the GPU restores into a CPU sampler
and the other way round.

A state sharded over a chain mesh (``parallel/``) saves as a collective,
as the JAX package's does (``mini_mcmc_tpu/checkpoint.py:39-50``): every
rank gathers each field along its chain axis (and, under a state split,
its state axis), mesh rank 0 writes the one file, and every rank waits at
a barrier. The file is the unsharded state's. :func:`restore_sampler`
takes ``mesh=`` to shard the restored state's chains over it.
"""

from __future__ import annotations

import os
import weakref
import zlib
from typing import Any

import torch

from .ops.elliptical import EllipticalState
from .ops.ensemble import EnsembleState
from .ops.gibbs import GibbsState
from .ops.hmc import HMCSepState, HMCState
from .ops.mh import MHState
from .ops.nuts import NUTSState
from .ops.sgmcmc import SGHMCState, SGLDState
from .ops.slice import SliceState
from .ops.tempering import PTState
from .parallel.collectives import barrier, gather_chains, gather_state, split
from .parallel.mesh import local_state, shard_sampler_state
from .stats import TrackerState
from .utils.init import resolve_device

FORMAT = "mini_mcmc_torch.checkpoint"
FORMAT_VERSION = 1
#: the state types a checkpoint may hold, by name
STATE_TYPES = {cls.__name__: cls for cls in (
    HMCState, HMCSepState, NUTSState, MHState, GibbsState, PTState,
    EnsembleState, SliceState, EllipticalState, SGLDState, SGHMCState,
    TrackerState)}
#: where a bijector's numeric fingerprint evaluates ``forward`` and
#: ``log_det`` (float32, on the CPU)
PROBE_POINTS = (-3.1, -1.2, -0.3, 0.0, 0.4, 1.1, 2.7)


def _check_backend(backend: str) -> None:
    if backend in ("orbax", "npz"):
        raise ValueError(
            f"backend={backend!r} is a checkpoint format of the JAX package "
            "(mini_mcmc_tpu); mini_mcmc_torch writes one torch.save file, "
            "<path>.pt: use backend='auto' or 'torch'")
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` that owns its storage (``torch.save`` writes a
    view's whole base storage)."""
    t = t.detach()
    return t.cpu() if t.device.type != "cpu" else t.clone()


def save_checkpoint(path: str, state: Any,
                    generator: torch.Generator | None = None, *,
                    backend: str = "auto", extra: Any = None) -> None:
    """Save a state of this package (a NamedTuple of
    :data:`STATE_TYPES`) and optionally a CPU ``generator``'s state to
    ``<path>.pt``.

    ``backend``: ``"auto"`` or ``"torch"``, the one format; ``"orbax"``
    and ``"npz"``, the JAX package's, raise ``ValueError``. ``extra``: a
    side record of plain values, tensors, lists and dicts stored alongside
    (``save_sampler`` puts the metric and transform records there). The
    file is written under a name of its own and renamed into place.

    A sharded state (DTensor leaves) is gathered whole on every rank, mesh
    rank 0 writes, and all ranks wait for the file: every rank of the mesh
    must call this.
    """
    _check_backend(backend)
    state, layout = local_state(state)
    if layout is not None:
        chains, st = layout.chains, layout.state

        def whole(x, axis, s_axis):
            if axis is False or not isinstance(axis, int):
                return x
            x = gather_chains(x, chains, axis)
            return x if s_axis is None else gather_state(x, st, s_axis)

        state = type(state)(*map(whole, state, layout.axes,
                                 layout.state_axes or (None,) * len(state)))
        if chains.rank == 0 and (st is None or st.rank == 0):
            save_checkpoint(path, state, generator, backend=backend,
                            extra=extra)
        # every rank waits for mesh rank 0: its chain group's barrier,
        # then its state group's (whose rank 0 passed its own chain
        # group's barrier after the writer)
        barrier(chains.group)
        if split(st):
            barrier(st.group)
        return
    name = type(state).__name__
    if STATE_TYPES.get(name) is not type(state):
        raise ValueError(f"cannot checkpoint a {name}: not a state type of "
                         f"mini_mcmc_torch ({sorted(STATE_TYPES)})")
    fields = {}
    for field, value in state._asdict().items():
        if isinstance(value, torch.Tensor):
            fields[field] = _to_host(value)
        elif isinstance(value, int):
            fields[field] = int(value)
        else:
            raise TypeError(f"{name}.{field} is a {type(value).__name__}, "
                            "neither a tensor nor a host int")
    payload = {
        "format": FORMAT, "version": FORMAT_VERSION, "type": name,
        "fields": fields,
        "generator": None if generator is None else generator.get_state(),
        "extra": extra,
    }
    target = path + ".pt"
    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)


def _load_payload(path: str) -> dict:
    target = path + ".pt"
    if not os.path.exists(target) and os.path.exists(path + ".tree"):
        raise ValueError(
            f"{path} is a checkpoint of the JAX package (a pickled treedef "
            "beside orbax or npz leaves), which mini_mcmc_torch does not "
            "read")
    payload = torch.load(target, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{target} is not a mini_mcmc_torch checkpoint")
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError(f"{target} has checkpoint format version "
                         f"{payload.get('version')!r}; this package reads "
                         f"version {FORMAT_VERSION}")
    if payload.get("type") not in STATE_TYPES:
        raise ValueError(f"{target} holds an unknown state type "
                         f"{payload.get('type')!r}")
    fields = set(payload["fields"])
    want = set(STATE_TYPES[payload["type"]]._fields)
    if fields != want:
        raise ValueError(f"{target}'s {payload['type']} has the fields "
                         f"{sorted(fields)}, not {sorted(want)}")
    return payload


def _generator(gen_state) -> torch.Generator | None:
    if gen_state is None:
        return None
    gen = torch.Generator()
    gen.set_state(gen_state)
    return gen


def load_checkpoint(path: str, device="cuda"):
    """Load a checkpoint written by :func:`save_checkpoint`.

    Returns ``(state, generator)``: the state rebuilt as its NamedTuple
    with its tensors on ``device`` (``"cuda"`` by default; raises without
    a GPU; pass ``device="cpu"`` for the CPU), and a CPU
    ``torch.Generator`` in the saved state, or ``None`` if none was saved.
    """
    device = resolve_device(device)
    payload = _load_payload(path)
    cls = STATE_TYPES[payload["type"]]
    state = cls(**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                   for k, v in payload["fields"].items()})
    return state, _generator(payload["generator"])


def _metric_record(sampler):
    """The sampler's metric as a comparable record (``None`` when
    unmetriced): ``dense`` 0 or 1 and its ``scale`` or ``chol``, a scale
    split over a state axis gathered whole (every rank of the axis
    calls this)."""
    metric = getattr(sampler, "metric", None)
    if metric is None:
        return None
    arr = metric.scale if metric.kind == "diag" else metric.chol
    if type(arr).__name__ == "DTensor":
        arr = arr.full_tensor()
    return {"dense": int(metric.kind == "dense"), "arr": _to_host(arr)}


#: probe fingerprints by bijector: weak keys, so that a probed bijector
#: (and what its closures hold) can still be collected
_PROBE_CRC: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _probe_text(bij) -> str:
    """A bijector's name and its ``forward`` and ``log_det`` at
    :data:`PROBE_POINTS` (float32, CPU), each to five significant digits,
    so that a difference of a few ulps between the saving and the
    restoring host does not change the text away from a rounding
    boundary."""
    y = torch.tensor(PROBE_POINTS, dtype=torch.float32)
    with torch.no_grad():
        vals = torch.cat([torch.as_tensor(bij.forward(y)).reshape(-1),
                          torch.as_tensor(bij.log_det(y)).reshape(-1)])
    # + 0.0 turns -0.0 into 0.0
    return bij.name + "|" + ",".join(
        f"{v + 0.0:.4e}" for v in vals.double().tolist())


def _bijector_probe_crc(bij) -> int:
    """crc32 of :func:`_probe_text`: what tells apart two custom maps
    that both kept the default name ``"bijector"``."""
    crc = _PROBE_CRC.get(bij)
    if crc is None:
        crc = _PROBE_CRC[bij] = zlib.crc32(_probe_text(bij).encode())
    return crc


def _transform_record(sampler):
    """The sampler's transform as a comparable record (``None`` without
    one, or for the identity): per coordinate the crc32 of the bijector's
    name (``bij``) and of its probe (``bijv``)."""
    tf = getattr(sampler, "transform", None)
    if tf is None or tf.is_identity:
        return None
    return {"bij": [zlib.crc32(b.name.encode()) for b in tf._table],
            "bijv": [_bijector_probe_crc(b) for b in tf._table]}


def save_sampler(path: str, sampler, *, backend: str = "auto") -> None:
    """Checkpoint a sampler: its state, its generator and the records of
    its metric and transform. The state is in the kernels' coordinates
    (unconstrained under a transform, whitened under a metric), so
    :func:`restore_sampler` refuses a sampler whose coordinates differ."""
    extra = {"metric": _metric_record(sampler),
             "transform": _transform_record(sampler)}
    save_checkpoint(path, sampler.state, sampler._gen, backend=backend,
                    extra=extra)


def _metric_kind(rec):
    if rec is None:
        return None
    return "dense" if rec["dense"] else "diag"


def restore_sampler(path: str, sampler, *, mesh=None):
    """Restore a checkpoint's state and generator into ``sampler``, built
    with the configuration of the saved one (any seed, any device).
    Returns the sampler; its next ``run`` continues the saved sampler's
    chains bit for bit.

    ``mesh``: a chain mesh (``parallel.chain_mesh``) to shard the restored
    state's chains over (chains only, as the JAX package's); a sharded
    sampler restored without one is resharded over its own mesh, its D
    split again if it was. The shards then continue the chains bit for bit
    too.

    Each field moves to the device and dtype of the sampler's own. Raises
    ``ValueError`` when the checkpoint holds another state type (an NUTS
    state for an HMC sampler), when a field's shape differs (another
    chain count, dimension or ladder), or when the metric or the transform
    differs from the sampler's: the state is stored whitened and
    unconstrained, so restoring it through another map would silently
    move every position.
    """
    payload = _load_payload(path)
    cur = sampler.state
    if payload["type"] != type(cur).__name__:
        raise ValueError(
            f"checkpoint holds a {payload['type']}, and the sampler's state "
            f"is a {type(cur).__name__}: restore into a sampler of the kind "
            "that saved it")
    extra = payload["extra"] or {}
    saved_tf, cur_tf = extra.get("transform"), _transform_record(sampler)
    tf_mismatch = (saved_tf is None) != (cur_tf is None)
    if not tf_mismatch and saved_tf is not None:
        tf_mismatch = (saved_tf["bij"] != cur_tf["bij"]
                       or saved_tf["bijv"] != cur_tf["bijv"])
    if tf_mismatch:
        raise ValueError(
            "checkpoint coordinate transform does not match the "
            "sampler's: the state is stored in unconstrained "
            "coordinates, so restoring it through a different transform "
            "would silently mis-map every position. Construct the "
            "restoring sampler with the same transform= the checkpoint "
            "was saved under.")
    saved_m, cur_m = extra.get("metric"), _metric_record(sampler)
    mismatch = (saved_m is None) != (cur_m is None)
    if not mismatch and saved_m is not None:
        a, b = saved_m["arr"].double(), cur_m["arr"].double()
        mismatch = (saved_m["dense"] != cur_m["dense"]
                    or a.shape != b.shape
                    or not torch.allclose(a, b, rtol=1e-6))
    if mismatch:
        raise ValueError(
            "checkpoint metric does not match the sampler's "
            f"(saved: {_metric_kind(saved_m)!r}, sampler: "
            f"{_metric_kind(cur_m)!r}); construct the restoring sampler "
            "with the same metric= the checkpoint was saved under")

    fields = {}
    for name in cur._fields:
        ref, new = getattr(cur, name), payload["fields"][name]
        if isinstance(ref, torch.Tensor) != isinstance(new, torch.Tensor):
            raise ValueError(
                f"checkpoint field {name} is a {type(new).__name__}, the "
                f"sampler's a {type(ref).__name__}")
        if isinstance(ref, torch.Tensor):
            if new.shape != ref.shape:
                raise ValueError(
                    f"checkpoint shape {tuple(new.shape)} ({name}) does not "
                    f"match sampler state shape {tuple(ref.shape)}; was the "
                    "sampler constructed with the same configuration?")
            new = new.to(device=ref.device, dtype=ref.dtype)
        fields[name] = new
    state = type(cur)(**fields)
    layout = getattr(sampler, "_layout", None)
    split_d = False
    if mesh is None and layout is not None:
        mesh, split_d = layout.mesh, layout.state is not None
    sampler.state = (state if mesh is None
                     else shard_sampler_state(mesh, state,
                                              shard_state_dim=split_d))
    gen = _generator(payload["generator"])
    if gen is not None:
        sampler._gen = gen
    return sampler
