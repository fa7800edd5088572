"""Wire-level KV block migration: the port's own copy of the reference's
wire format (``k8s_gpu_tpu/serve/migrate.py``: ``WIRE_VERSION``,
``pack``, ``unpack``, ``payload_bytes``), so a torch replica's paged pool
exports and imports the very payloads a JAX replica does.

A payload is JSON: ``version``, ``page_size``, ``replica``, a
``geometry`` of one block's contents per cache leaf (``arr[:, blk]``:
dtype name and shape), the registered blocks sorted by chain hash, each
leaf base64 of its raw bytes, the live-request manifest and the count of
streams an export aborted.  No timestamps, no ambient ids: two exports of
the same pool state are byte-identical under ``payload_bytes``.

bf16 leaves.  The reference names a bf16 leaf ``"bfloat16"`` (numpy's
name for ``ml_dtypes.bfloat16``) and writes its raw little-endian 16-bit
words.  The port has no ``ml_dtypes``: a bf16 leaf travels here as the
same words in a ``uint16`` array under the name ``"bfloat16"``, and the
pool views them as ``torch.bfloat16`` with no float round trip, so the
bytes on the wire are the reference's for the same values.

The gateway's coordinator (the reference's ``BlockMigrator``) is not part
of a replica and is not ported.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import torch

WIRE_VERSION = 1

# Pool dtype -> wire dtype name.
_WIRE_NAME = {torch.float32: "float32", torch.float16: "float16",
              torch.bfloat16: "bfloat16", torch.int8: "int8"}
# Wire dtype name -> the numpy dtype its bytes are held in on the host,
# for the dtypes numpy cannot name, and the torch integer type a pool
# tensor of that dtype is viewed as on the way (no float round trip).
_WORDS = {"bfloat16": np.dtype("<u2")}
_TORCH_WORDS = {torch.bfloat16: torch.int16}


def wire_name(dtype: torch.dtype) -> str:
    """A pool leaf's torch dtype -> its wire dtype name.  ValueError for
    a dtype the wire does not carry."""
    if dtype not in _WIRE_NAME:
        raise ValueError(f"no wire name for {dtype}")
    return _WIRE_NAME[dtype]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A pool tensor on the host in its wire dtype's host dtype (bf16 as
    ``uint16`` words)."""
    t = t.cpu()
    if t.dtype in _TORCH_WORDS:
        return t.view(_TORCH_WORDS[t.dtype]).numpy().view(np.uint16)
    return t.numpy()


def from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host bytes (``to_host``'s form) -> a CPU tensor of ``dtype``."""
    a = np.ascontiguousarray(a)
    if dtype in _TORCH_WORDS:
        return torch.from_numpy(a.view(np.int16)).view(dtype)
    return torch.from_numpy(a)


def wire_dtype(name) -> tuple[str, np.dtype]:
    """A leaf's wire dtype name -> (canonical name, host dtype of its
    bytes, little-endian).  ValueError for a name that names no dtype."""
    name = str(name)
    if name in _WORDS:
        return name, _WORDS[name]
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown dtype {name!r}") from e
    return dt.name, dt.newbyteorder("<")


def pack(snapshot: dict) -> dict:
    """Serialize an export snapshot (``migrate_export``'s return value:
    host block bodies keyed by hash bytes, each leaf in its wire dtype's
    host dtype) into the JSON-safe payload.  Deterministic: blocks
    sorted by hash, leaves by name."""
    geometry = {
        name: {"dtype": str(g["dtype"]),
               "shape": [int(s) for s in g["shape"]]}
        for name, g in sorted(snapshot.get("geometry", {}).items())
    }
    blocks = []
    for h, leaves in sorted(snapshot.get("blocks", []), key=lambda kv: kv[0]):
        data = {
            name: base64.b64encode(
                np.ascontiguousarray(leaves[name]).tobytes()
            ).decode("ascii")
            for name in sorted(leaves)
        }
        blocks.append({"hash": h.hex(), "data": data})
    return {
        "version": WIRE_VERSION,
        "page_size": int(snapshot.get("page_size", 0)),
        "replica": str(snapshot.get("replica", "")),
        "geometry": geometry,
        "blocks": blocks,
        "requests": list(snapshot.get("requests", [])),
        "aborted": int(snapshot.get("aborted", 0)),
    }


def unpack(payload: dict) -> dict:
    """Parse and validate a payload into host block bodies (bf16 leaves
    as ``uint16`` words).  ValueError on a version, geometry, hash or
    length problem: the import side refuses malformed state before it
    touches a pool."""
    if int(payload.get("version", -1)) != WIRE_VERSION:
        raise ValueError(f"migrate wire version {payload.get('version')!r} "
                         f"!= {WIRE_VERSION}")
    geometry = payload.get("geometry") or {}
    if not isinstance(geometry, dict) or not geometry:
        raise ValueError("migrate payload missing geometry")
    shapes: dict[str, tuple] = {}
    names: dict[str, str] = {}
    host: dict[str, np.dtype] = {}
    for name in sorted(geometry):
        g = geometry[name]
        try:
            names[name], host[name] = wire_dtype(g["dtype"])
            shapes[name] = tuple(int(s) for s in g["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad geometry for leaf {name!r}: {e}") from e
    blocks: list[tuple[bytes, dict[str, np.ndarray]]] = []
    for ent in payload.get("blocks", []):
        try:
            h = bytes.fromhex(ent["hash"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad block hash: {e}") from e
        data = ent.get("data") or {}
        if sorted(data) != sorted(shapes):
            raise ValueError(f"block {ent.get('hash')}: leaves "
                             f"{sorted(data)} != geometry {sorted(shapes)}")
        leaves: dict[str, np.ndarray] = {}
        for name in sorted(data):
            raw = base64.b64decode(data[name])
            want = int(np.prod(shapes[name])) * host[name].itemsize
            if len(raw) != want:
                raise ValueError(f"block {ent.get('hash')} leaf {name}: "
                                 f"{len(raw)} bytes != expected {want}")
            leaves[name] = np.frombuffer(raw, host[name]).reshape(
                shapes[name])
        blocks.append((h, leaves))
    return {
        "page_size": int(payload.get("page_size", 0)),
        "geometry": {name: {"dtype": names[name], "shape": shapes[name]}
                     for name in sorted(shapes)},
        "blocks": blocks,
        "requests": list(payload.get("requests", [])),
    }


def payload_bytes(payload: dict) -> bytes:
    """The canonical encoding of a payload: sorted keys, compact
    separators; byte-identical across runs for identical pool state."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
