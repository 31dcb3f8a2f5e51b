"""A reader of the safetensors format, with no dependency beyond torch.

The format (https://github.com/huggingface/safetensors): an 8-byte
little-endian header length N, N bytes of JSON — ``{name: {"dtype",
"shape", "data_offsets": [begin, end]}, "__metadata__": {...}}`` with
offsets relative to the byte after the header — then the tensors' raw
little-endian bytes.

:class:`SafetensorsFile` maps the file and hands out each tensor as a
zero-copy CPU view of the mapping. The mapping is private
(copy-on-write): the file is never written, and the pages a reader
touches are read from disk on demand, so a loader that reads one layer at
a time holds one layer's pages, not the checkpoint.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

# safetensors dtype names -> torch dtypes (the ones llama and mixtral
# checkpoints, and the port's own writers, use).
DTYPES: dict[str, torch.dtype] = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I32": torch.int32,
    "I64": torch.int64,
}

# A header larger than this is not a checkpoint's (the format's own
# reader caps it at 100 MB).
_MAX_HEADER = 100_000_000


class SafetensorsError(ValueError):
    """The file is not a well-formed safetensors file."""


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the offset of the data
    section) of ``path``. Raises :class:`SafetensorsError` on a header
    that does not parse or whose entries do not fit the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header "
                                   "length")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER or 8 + n > size:
            raise SafetensorsError(f"{path}: header length {n} does not fit "
                                   f"a {size}-byte file")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f"{path}: header is not JSON ({e})") \
                from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    _check_entries(path, header, size - 8 - n)
    return header, 8 + n


def _check_entries(path: str, header: dict, data_len: int) -> None:
    """Every entry's dtype is known, its byte range matches its shape and
    lies inside the data section, and no two ranges overlap."""
    spans = []
    for name, e in header.items():
        try:
            dtype = DTYPES[e["dtype"]]
            shape = [int(d) for d in e["shape"]]
            begin, end = (int(x) for x in e["data_offsets"])
        except KeyError as err:
            raise SafetensorsError(f"{path}: tensor {name!r}: unsupported "
                                   f"or missing field {err}") from None
        except (TypeError, ValueError):
            raise SafetensorsError(f"{path}: tensor {name!r}: malformed "
                                   "entry") from None
        numel = 1
        for d in shape:
            if d < 0:
                raise SafetensorsError(f"{path}: tensor {name!r}: negative "
                                       "dimension")
            numel *= d
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= data_len:
            raise SafetensorsError(
                f"{path}: tensor {name!r}: data_offsets [{begin}, {end}] "
                f"lie outside the {data_len}-byte data section")
        if end - begin != nbytes:
            raise SafetensorsError(
                f"{path}: tensor {name!r}: data_offsets span {end - begin} "
                f"bytes, its shape {shape} of {e['dtype']} needs {nbytes}")
        spans.append((begin, end, name))
    spans.sort()
    for (b0, e0, n0), (b1, e1, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise SafetensorsError(f"{path}: tensors {n0!r} and {n1!r} "
                                   "overlap in the data section")


class SafetensorsFile:
    """One mapped safetensors file. ``get(name)`` is a CPU tensor viewing
    the mapping (no copy); it stays valid while this object is open."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._header, self._start = read_header(path)
        self._mm = None
        if any(e["data_offsets"][1] > e["data_offsets"][0]
               for e in self._header.values()):
            with open(path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self) -> list[str]:
        return list(self._header)

    def get(self, name: str) -> torch.Tensor:
        e = self._header[name]
        dtype = DTYPES[e["dtype"]]
        shape = tuple(int(d) for d in e["shape"])
        begin, end = (int(x) for x in e["data_offsets"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._mm, dtype=torch.uint8,
                                count=end - begin,
                                offset=self._start + begin)
        return flat.view(dtype).view(shape)

    def close(self) -> None:
        # Views handed out keep the buffer exported; the mapping then
        # closes with its last view.
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
