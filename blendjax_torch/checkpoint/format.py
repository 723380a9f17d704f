"""On-disk snapshot format (the port's copy of ``blendjax/checkpoint/format.py``,
the same format byte for byte): pickle-free, shard-addressed, atomic.

One directory per committed step holds two stores:

- **array store** (``arrays/NNNN.S.bin``): every train-state leaf as raw
  C-order bytes, one file per shard, the manifest recording each shard's
  global index extents. The port runs on one device, so a tensor is one
  shard with whole extents; reading assembles any shard partition the
  JAX package wrote (a snapshot of a mesh) into the global array.
- **session store** (``session.msgpack``): the host-side run state as a
  msgpack document; arrays ride as ``{"__nd__": dtype, "shape", "data"}``
  and integers wider than 64 bits (numpy's PCG64 state words) as
  ``{"__bigint__": hex}``.

``manifest.json`` is the commit record: it is written last into a
``.tmp-`` staging directory that an ``os.replace`` renames into place
(:mod:`blendjax_torch.checkpoint.snapshot`), so a killed writer never
leaves a half-readable committed step.

A state is a flat mapping from leaf path (the JAX package's
``jax.tree_util.keystr`` names, :func:`blendjax_torch.weights.train_state_leaves`)
to a torch tensor, a numpy array or a Python scalar.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

MANIFEST = "manifest.json"
SESSION_FILE = "session.msgpack"
ARRAYS_DIR = "arrays"
FORMAT_VERSION = 1

# the session codec's marker keys; user dicts may not use them
_ND_KEY = "__nd__"
_BIG_KEY = "__bigint__"
_MARKERS = (_ND_KEY, _BIG_KEY)

_INT64_MIN = -(2**63)
_UINT64_MAX = 2**64 - 1


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 has no numpy dtype and is
    refused: the snapshot writes what the JAX package can read)."""
    if t.dtype == torch.bfloat16:
        raise TypeError("bf16 tensors have no numpy dtype: snapshot f32")
    return t.detach().cpu().contiguous().numpy()


# -- session codec (msgpack, pickle-free) ----------------------------------------


def _encode(obj, path: str = "$"):
    if obj is None or isinstance(obj, (bool, str, bytes)):
        return obj
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, (int, np.integer)):
        v = int(obj)
        if _INT64_MIN <= v <= _UINT64_MAX:
            return v
        return {_BIG_KEY: hex(v)}  # PCG64 state words are 128-bit
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (list, tuple)):
        return [_encode(v, f"{path}[{i}]") for i, v in enumerate(obj)]
    if isinstance(obj, dict):
        for marker in _MARKERS:
            if marker in obj:
                raise ValueError(
                    f"session dict at {path} uses reserved codec key "
                    f"{marker!r}"
                )
        out = {}
        for k, v in obj.items():
            if not isinstance(k, (str, int)):
                raise TypeError(
                    f"session dict key at {path} must be str or int, got "
                    f"{type(k).__name__}"
                )
            out[k] = _encode(v, f"{path}[{k!r}]")
        return out
    if isinstance(obj, torch.Tensor):
        # the snapshot writer cloned it; the copy to the host runs here,
        # on the writer thread
        obj = to_numpy(obj)
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError(
                f"session array at {path} has object dtype: the session "
                "store is pickle-free"
            )
        return {
            _ND_KEY: str(obj.dtype),
            "shape": list(obj.shape),
            "data": np.ascontiguousarray(obj).tobytes(),
        }
    raise TypeError(
        f"session value at {path} is not serializable without pickle: "
        f"{type(obj).__name__}; reduce it to dict/list/scalar/ndarray in the "
        "component's state_dict()"
    )


def _decode(obj):
    if isinstance(obj, dict):
        if _ND_KEY in obj:
            return (np.frombuffer(obj["data"], dtype=np.dtype(obj[_ND_KEY]))
                    .reshape(tuple(obj["shape"])).copy())
        if _BIG_KEY in obj:
            return int(obj[_BIG_KEY], 16)
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def pack_session(session: dict) -> bytes:
    """One session dict -> msgpack bytes; raises ``TypeError`` naming the
    path of anything that would need pickle."""
    import msgpack

    return msgpack.packb(_encode(session), use_bin_type=True)


def unpack_session(raw: bytes) -> dict:
    import msgpack

    return _decode(msgpack.unpackb(raw, raw=False, strict_map_key=False))


# -- array store ---------------------------------------------------------------------


def _whole(shape) -> list:
    return [[0, int(d)] for d in shape]


def _write(arrays: str, fname: str, data: np.ndarray) -> int:
    with open(os.path.join(arrays, fname), "wb") as f:
        f.write(np.ascontiguousarray(data).tobytes())
    return int(data.nbytes)


def write_state(directory: str, state: dict) -> tuple:
    """Write every leaf of ``state`` (path -> tensor, array or scalar)
    into ``directory/arrays/``; returns ``(manifest_leaves, total_bytes)``.
    A tensor's copy to the host (``.cpu()``) runs here, on the caller's
    (the writer's) thread."""
    arrays = os.path.join(directory, ARRAYS_DIR)
    os.makedirs(arrays, exist_ok=True)
    leaves = []
    total = 0
    for i, (path, leaf) in enumerate(state.items()):
        if isinstance(leaf, torch.Tensor):
            leaf = to_numpy(leaf)
        if isinstance(leaf, (np.ndarray, np.generic)):
            data = np.asarray(leaf)
            fname = f"{i:04d}.0.bin"
            total += _write(arrays, fname, data)
            leaves.append({
                "path": path, "kind": "array", "dtype": str(data.dtype),
                "shape": list(data.shape),
                "shards": [{"file": fname, "index": _whole(data.shape)}],
            })
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            leaves.append({"path": path, "kind": "scalar", "value": leaf})
        else:
            raise TypeError(
                f"state leaf {path} is not snapshotable without pickle: "
                f"{type(leaf).__name__}"
            )
    return leaves, total


def assemble_leaf(directory: str, entry: dict) -> np.ndarray:
    """One manifest array entry -> its global host array, from whatever
    shard partition wrote it."""
    dtype = np.dtype(entry["dtype"])
    out = np.empty(tuple(entry["shape"]), dtype)
    filled = 0
    for shard in entry["shards"]:
        with open(os.path.join(directory, ARRAYS_DIR, shard["file"]),
                  "rb") as f:
            raw = f.read()
        idx = tuple(slice(a, b) for a, b in shard["index"])
        sub = tuple(b - a for a, b in shard["index"])
        data = np.frombuffer(raw, dtype=dtype).reshape(sub)
        out[idx] = data
        filled += data.size
    if filled < out.size:
        raise ValueError(
            f"snapshot leaf {entry['path']} is missing shards: "
            f"{filled}/{out.size} elements present"
        )
    return out


def read_state(directory: str, leaves: list, template=None) -> tuple:
    """Manifest ``leaves`` -> ``(state, resharded_leaves)``: ``state``
    maps each path of ``template`` (every saved path when ``None``) to its
    global host array or scalar; a template path the snapshot lacks
    raises. ``resharded_leaves`` counts the leaves saved in more than one
    shard (a JAX mesh) that this one device reassembled."""
    by_path = {e["path"]: e for e in leaves}
    paths = list(by_path) if template is None else list(template)
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise ValueError(
            f"snapshot does not cover template leaves {missing[:4]} "
            f"(+{max(len(missing) - 4, 0)} more): the template's structure "
            "must match the saved state's"
        )
    out = {}
    resharded = 0
    for path in paths:
        entry = by_path[path]
        if entry["kind"] == "scalar":
            out[path] = entry["value"]
            continue
        out[path] = assemble_leaf(directory, entry)
        resharded += len(entry["shards"]) != 1
    return out, resharded


def write_manifest(directory: str, manifest: dict) -> None:
    with open(os.path.join(directory, MANIFEST), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"snapshot {directory} has format {manifest.get('format')!r}; "
            f"this build reads {FORMAT_VERSION}"
        )
    return manifest


__all__ = [
    "ARRAYS_DIR",
    "FORMAT_VERSION",
    "MANIFEST",
    "SESSION_FILE",
    "assemble_leaf",
    "pack_session",
    "read_manifest",
    "read_state",
    "to_numpy",
    "unpack_session",
    "write_manifest",
    "write_state",
]
