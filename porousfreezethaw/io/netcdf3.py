"""Self-contained NetCDF classic (CDF-2 / 64-bit-offset) writer and reader.

The reference stores every snapshot (= checkpoint) as a NetCDF dataset with
dimensions ``n3, n2, n1``, double coordinate variables named like the
dimensions, double field variables ``u, p, gl``, and a global-attribute
block carrying the full computation state (``intertrack.c:2327-2455``).
This image has no netCDF library, so the classic file format is implemented
directly (~200 lines); files are readable by ncdump/scipy/xarray and by
this module (for `continue_series` resume and icond loading).

Layout written: header (dims, global attrs, var metadata), then
non-record variable data in definition order, 4-byte aligned — the classic
format specification (CDF magic, NC_DIMENSION=0x0A, NC_VARIABLE=0x0B,
NC_ATTRIBUTE=0x0C).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C

_DTYPE_TO_NC = {
    np.dtype(">i1"): NC_BYTE, np.dtype("S1"): NC_CHAR,
    np.dtype(">i2"): NC_SHORT, np.dtype(">i4"): NC_INT,
    np.dtype(">f4"): NC_FLOAT, np.dtype(">f8"): NC_DOUBLE,
}
_NC_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NC.items()}
_NC_SIZE = {NC_BYTE: 1, NC_CHAR: 1, NC_SHORT: 2, NC_INT: 4, NC_FLOAT: 4,
            NC_DOUBLE: 8}

AttrValue = Union[int, float, str, np.ndarray]


def _pad4(n: int) -> int:
    return (4 - n % 4) % 4


def _enc_name(name: str) -> bytes:
    b = name.encode()
    return struct.pack(">i", len(b)) + b + b"\x00" * _pad4(len(b))


def _nc_type_of(value: AttrValue) -> Tuple[int, np.ndarray]:
    if isinstance(value, str):
        return NC_CHAR, np.frombuffer(value.encode(), dtype="S1")
    arr = np.atleast_1d(np.asarray(value))
    if np.issubdtype(arr.dtype, np.integer):
        return NC_INT, arr.astype(">i4")
    return NC_DOUBLE, arr.astype(">f8")


def _enc_attrs(attrs: Dict[str, AttrValue]) -> bytes:
    if not attrs:
        return struct.pack(">ii", 0, 0)
    out = [struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))]
    for name, value in attrs.items():
        nct, arr = _nc_type_of(value)
        data = arr.tobytes()
        out.append(_enc_name(name))
        out.append(struct.pack(">ii", nct, len(arr)))
        out.append(data + b"\x00" * _pad4(len(data)))
    return b"".join(out)


@dataclasses.dataclass
class VarLayout:
    """File-layout entry of one variable: where its (row-major, big-endian)
    data block lives."""
    begin: int
    shape: Tuple[int, ...]
    nc_type: int


def _build_header(
    dims: Dict[str, int],
    var_specs: Sequence[Tuple[str, Sequence[str], int]],  # (name, dims, nct)
    attrs: Dict[str, AttrValue],
) -> Tuple[bytes, Dict[str, VarLayout], int]:
    """Encode the CDF-2 header; returns (header_bytes, layouts, total_size)."""
    dim_names = list(dims)
    dim_ids = {n: i for i, n in enumerate(dim_names)}

    header = [b"CDF\x02", struct.pack(">i", 0)]  # magic + numrecs
    header.append(struct.pack(">ii", _NC_DIMENSION, len(dims)))
    for n in dim_names:
        header.append(_enc_name(n) + struct.pack(">i", dims[n]))
    header.append(_enc_attrs(attrs))

    var_meta = []
    for name, vdims, nct in var_specs:
        shape = tuple(dims[d] for d in vdims)
        vsize = int(np.prod(shape, dtype=np.int64)) * _NC_SIZE[nct]
        vsize += _pad4(vsize)
        var_meta.append((name, tuple(vdims), shape, nct, vsize))

    var_block = struct.pack(">ii", _NC_VARIABLE, len(var_meta))
    fixed_entries = []
    for name, vdims, shape, nct, vsize in var_meta:
        entry = [_enc_name(name), struct.pack(">i", len(vdims))]
        for d in vdims:
            entry.append(struct.pack(">i", dim_ids[d]))
        entry.append(struct.pack(">ii", 0, 0))   # no per-var attributes
        entry.append(struct.pack(">ii", nct, min(vsize, 2**31 - 1)))
        fixed_entries.append(b"".join(entry))
    header_size = (sum(len(h) for h in header)
                   + len(var_block)
                   + sum(len(e) + 8 for e in fixed_entries))  # +8: begin (i64)

    offset = header_size
    layouts: Dict[str, VarLayout] = {}
    parts = list(header) + [var_block]
    for entry, (name, _, shape, nct, vsize) in zip(fixed_entries, var_meta):
        parts.append(entry)
        parts.append(struct.pack(">q", offset))
        layouts[name] = VarLayout(begin=offset, shape=shape, nc_type=nct)
        offset += vsize
    return b"".join(parts), layouts, offset


def write_netcdf(
    path: str,
    dims: Dict[str, int],
    variables: Sequence[Tuple[str, Sequence[str], np.ndarray]],
    attrs: Dict[str, AttrValue],
) -> None:
    """Write a classic 64-bit-offset NetCDF file.

    ``variables`` is a sequence of (name, dim_names, data); data is written
    as float64 unless it has an integer dtype (then int32).
    """
    arrs = {}
    var_specs = []
    for name, vdims, data in variables:
        arr = np.asarray(data)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(">i4")
            nct = NC_INT
        else:
            arr = arr.astype(">f8")
            nct = NC_DOUBLE
        expected = tuple(dims[d] for d in vdims)
        if arr.shape != expected:
            raise ValueError(
                f"variable {name!r}: shape {arr.shape} != dims {expected}")
        arrs[name] = arr
        var_specs.append((name, vdims, nct))

    header, layouts, _total = _build_header(dims, var_specs, attrs)
    with open(path, "wb") as f:
        f.write(header)
        for name, _, _ in var_specs:
            raw = arrs[name].tobytes()
            f.write(raw + b"\x00" * _pad4(len(raw)))


def create_netcdf(
    path: str,
    dims: Dict[str, int],
    var_specs: Sequence[Tuple[str, Sequence[str], int]],
    attrs: Dict[str, AttrValue],
) -> Dict[str, VarLayout]:
    """Create a classic NetCDF file with header only, pre-sized for its
    variables, to be filled with :func:`write_block` hyperslab writes —
    the gather-free analog of nc_create + nc_enddef.  Safe for several
    writers on a shared filesystem as long as their blocks are disjoint
    (each pwrites its own byte ranges)."""
    header, layouts, total = _build_header(dims, var_specs, attrs)
    with open(path, "wb") as f:
        f.write(header)
        f.truncate(total)
    return layouts


def write_block(path: str, layout: VarLayout, block: np.ndarray,
                start: Sequence[int]) -> None:
    """Write a hyperslab ``block`` into variable ``layout`` at corner
    ``start`` (the nc_put_vara analog, ``intertrack.c:2536-2546``): one
    pwrite per contiguous run (trailing dims that span the variable are
    coalesced)."""
    dtype = _NC_TO_DTYPE[layout.nc_type]
    isize = _NC_SIZE[layout.nc_type]
    block = np.ascontiguousarray(np.asarray(block), dtype=dtype)
    shape = layout.shape
    if len(block.shape) != len(shape):
        raise ValueError(f"block rank {block.shape} vs var {shape}")
    for s, b, n in zip(start, block.shape, shape):
        if s < 0 or s + b > n:
            raise ValueError(f"block {block.shape}@{tuple(start)} "
                             f"outside variable {shape}")
    # trailing dims fully covered by the block form one contiguous run
    ndim = len(shape)
    run = ndim
    while run > 0 and block.shape[run - 1] == shape[run - 1] \
            and start[run - 1] == 0:
        run -= 1
    run = min(run, ndim - 1) if ndim else 0
    lead_shape = block.shape[:run]
    run_elems = int(np.prod(block.shape[run:], dtype=np.int64))
    strides = np.ones(ndim, dtype=np.int64)
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    flat = block.reshape(lead_shape + (run_elems,))
    base = sum(start[d] * int(strides[d]) for d in range(ndim))
    with open(path, "r+b") as f:
        for idx in np.ndindex(*lead_shape):
            off = base + sum(idx[d] * int(strides[d]) for d in range(run))
            f.seek(layout.begin + off * isize)
            f.write(flat[idx].tobytes())


@dataclasses.dataclass
class NetCDFData:
    dims: Dict[str, int]
    variables: Dict[str, np.ndarray]
    var_dims: Dict[str, Tuple[str, ...]]
    attrs: Dict[str, AttrValue]


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self.read(8))[0]

    def name(self) -> str:
        n = self.i4()
        s = self.read(n).decode()
        self.read(_pad4(n))
        return s

    def attr_value(self):
        nct = self.i4()
        nelems = self.i4()
        size = nelems * _NC_SIZE[nct]
        raw = self.read(size)
        self.read(_pad4(size))
        if nct == NC_CHAR:
            return raw.decode(errors="replace")
        arr = np.frombuffer(raw, dtype=_NC_TO_DTYPE[nct])
        if len(arr) == 1:
            return arr[0].item()
        return np.array(arr)


def read_netcdf(path: str) -> NetCDFData:
    """Read a classic NetCDF (CDF-1 or CDF-2) file written by this module
    (or any writer using non-record variables)."""
    with open(path, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    magic = r.read(4)
    if magic[:3] != b"CDF" or magic[3] not in (1, 2):
        raise ValueError(f"{path}: not a classic NetCDF file")
    offsets64 = magic[3] == 2
    r.i4()  # numrecs

    dims: Dict[str, int] = {}
    tag = r.i4()
    count = r.i4()
    dim_names: List[str] = []
    if tag == _NC_DIMENSION:
        for _ in range(count):
            n = r.name()
            dims[n] = r.i4()
            dim_names.append(n)

    attrs: Dict[str, AttrValue] = {}
    tag, count = r.i4(), r.i4()
    if tag == _NC_ATTRIBUTE:
        for _ in range(count):
            n = r.name()
            attrs[n] = r.attr_value()

    variables: Dict[str, np.ndarray] = {}
    var_dims: Dict[str, Tuple[str, ...]] = {}
    tag, count = r.i4(), r.i4()
    if tag == _NC_VARIABLE:
        for _ in range(count):
            vname = r.name()
            ndims = r.i4()
            vdims = tuple(dim_names[r.i4()] for _ in range(ndims))
            # per-var attributes (skipped into the void)
            atag, acount = r.i4(), r.i4()
            if atag == _NC_ATTRIBUTE:
                for _ in range(acount):
                    r.name()
                    r.attr_value()
            nct = r.i4()
            r.i4()  # vsize
            begin = r.i8() if offsets64 else r.i4()
            shape = tuple(dims[d] for d in vdims)
            n_items = int(np.prod(shape)) if shape else 1
            raw = buf[begin:begin + n_items * _NC_SIZE[nct]]
            arr = np.frombuffer(raw, dtype=_NC_TO_DTYPE[nct]).reshape(shape)
            variables[vname] = arr.astype(arr.dtype.newbyteorder("="))
            var_dims[vname] = vdims

    return NetCDFData(dims=dims, variables=variables, var_dims=var_dims,
                      attrs=attrs)
