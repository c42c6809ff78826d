"""Flax weights in the port: the msgpack files and the param tree.

The reference saves a network's parameters with
``flax.serialization.to_bytes`` -- msgpack, with every array packed as
extension type 1 holding ``(shape, dtype name, raw C-order bytes)``.
The card machine has neither ``msgpack`` nor ``flax``, so this module
reads and writes that format with the standard library alone
(:func:`read_flax_msgpack`, :func:`write_flax_msgpack`), and maps the
param tree onto the port's modules (:func:`params_from_flax`) and back
(:func:`params_to_flax`):

* ``trunk/conv{i}/kernel`` HWIO ↔ ``trunk.convs.{i-1}.weight`` OIHW,
  ``bias`` as is;
* ``head/conv/kernel`` and ``bias`` ↔ ``head.conv.weight``/``bias``;
* ``head/position_bias`` (legacy ``bias`` head) ↔ ``head.position_bias``.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# --------------------------------------------------------------------------
# msgpack, the subset flax writes
# --------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, k: int) -> bytes:
        if self.pos + k > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + k])
        self.pos += k
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if t in lengths:                                   # bin
            return self.take(self.unpack(lengths[t]))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if t in ext:
            size = self.unpack(ext[t])
            return self._ext(self.unpack("b"), self.take(size))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(self.unpack("b"), self.take(fixext[t]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in numbers:
            return self.unpack(numbers[t])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if t in strs:
            return self.take(self.unpack(strs[t])).decode()
        if t in (0xDC, 0xDD):
            return [self.read()
                    for _ in range(self.unpack("H" if t == 0xDC else "I"))]
        if t in (0xDE, 0xDF):
            return self._map(self.unpack("H" if t == 0xDE else "I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, k: int) -> dict:
        out = {}
        for _ in range(k):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def _ext(code: int, payload: bytes):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(payload).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _pack(obj, out: list) -> None:
    """Append the msgpack of ``obj`` -- the types a param tree holds:
    dicts, str keys, numpy arrays (and, inside them, int shapes, the
    dtype name and the raw bytes)."""
    if isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        else:
            out.append(b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(b"\xdb" + struct.pack(">I", len(raw)) + raw)
    elif isinstance(obj, bytes):
        out.append(b"\xc6" + struct.pack(">I", len(obj)) + obj)
    elif isinstance(obj, (list, tuple)):
        out.append(b"\xdd" + struct.pack(">I", len(obj)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(b"\xdf" + struct.pack(">I", len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        inner: list = []
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), inner)
        payload = b"".join(inner)
        out.append(b"\xc9" + struct.pack(">Ib", len(payload), _EXT_NDARRAY)
                   + payload)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def read_flax_msgpack(path: str) -> dict:
    """A ``*.flax.msgpack`` file → its nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack tree")
    return tree


def write_flax_msgpack(path: str, tree: dict) -> None:
    """Write ``tree`` (nested dicts of numpy arrays) in the format
    ``flax.serialization.from_bytes`` reads; atomic (tmp + rename)."""
    out: list = []
    _pack(tree, out)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# param tree ↔ state dict
# --------------------------------------------------------------------------


def _tensor(a, hwio: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if hwio else a))


def params_from_flax(tree: dict) -> dict:
    """The reference's policy param tree (``{"params": {...}}`` or its
    inner dict) as numpy → a ``state_dict`` of the port's
    :class:`~.policy.PolicyNet`."""
    params = tree.get("params", tree)
    sd = {}
    for name, leaf in params["trunk"].items():
        if not name.startswith("conv"):
            raise ValueError(f"unsupported trunk module {name!r} "
                             "(global pooling waits for a later slice)")
        i = int(name[len("conv"):]) - 1
        sd[f"trunk.convs.{i}.weight"] = _tensor(leaf["kernel"], hwio=True)
        sd[f"trunk.convs.{i}.bias"] = _tensor(leaf["bias"])
    head = params["head"]
    sd["head.conv.weight"] = _tensor(head["conv"]["kernel"], hwio=True)
    sd["head.conv.bias"] = _tensor(head["conv"]["bias"])
    if "position_bias" in head:
        sd["head.position_bias"] = _tensor(head["position_bias"])
    return sd


def params_to_flax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_flax`: ``{"params": {...}}`` with
    float32 numpy leaves, as ``flax.serialization.to_bytes`` saves a
    freshly initialised reference module."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    trunk, head = {}, {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] == "trunk":
            conv = trunk.setdefault(f"conv{int(parts[2]) + 1}", {})
            conv["kernel" if parts[3] == "weight" else "bias"] = (
                arr(t).transpose(2, 3, 1, 0).copy()
                if parts[3] == "weight" else arr(t))
        elif parts[1] == "conv":
            head.setdefault("conv", {})[
                "kernel" if parts[2] == "weight" else "bias"] = (
                arr(t).transpose(2, 3, 1, 0).copy()
                if parts[2] == "weight" else arr(t))
        else:
            head["position_bias"] = arr(t)
    return {"params": {"trunk": trunk, "head": head}}
