"""Units-aware labeled array (climt_tpu/core/dataarray.py).

A thin host-side label, (array, dims, attrs), around a numpy array or a
torch tensor.  ``get_default_state`` builds numpy-backed DataArrays; the
components return tensors on their device, so after the first component
call a state holds both.  Every operation dispatches on the wrapped
array's kind, and where a numpy array meets a tensor, ``common_backend``
moves the numpy side to the tensor's device and floating dtype.

A tensor held as ``DataArray.values`` is a ``HostTensor``: the same
tensor on the same device, which ``np.asarray`` copies to the host
wherever it lives (as ``np.asarray`` of a ``jax.Array`` does), and on
which every torch operation returns a plain tensor.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from .units import conversion_factor, units_are_same


def common_backend(*values):
    """``values`` as operands of one another: when any of them is a torch
    tensor, every numpy array (or numpy scalar) among them becomes a
    tensor on the first tensor's device, with its dtype if that is
    floating.  Python scalars and tensors pass through."""
    like = next((v for v in values if isinstance(v, torch.Tensor)), None)
    if like is None:
        return values
    dtype = like.dtype if like.is_floating_point() else None
    return tuple(
        as_tensor(v, like.device, dtype)
        if isinstance(v, (np.ndarray, np.generic)) else v for v in values)


class HostTensor(torch.Tensor):
    """A tensor that numpy reads on any device: ``np.asarray`` copies it
    to the host.  Every torch operation on it returns a plain tensor (the
    subclass goes no further than the ``.values`` that hold it), and an
    in-place write (``values[:] = ...``) writes the tensor where it
    lives."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        return np.asarray(to_numpy(self.as_subclass(torch.Tensor)),
                          dtype=dtype)


def as_tensor(values, device, dtype=None):
    """A plain tensor on ``device`` of a numpy array (any strides,
    read-only views included), scalar or tensor."""
    if isinstance(values, HostTensor):
        values = values.as_subclass(torch.Tensor)
    elif not isinstance(values, torch.Tensor):
        values = np.ascontiguousarray(values)
    return torch.as_tensor(values, dtype=dtype, device=device)


def to_numpy(values):
    """Host numpy array of a numpy array, tensor (on any device) or
    scalar."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


class DataArray:
    __slots__ = ('_values', 'dims', 'attrs', 'name')

    @property
    def values(self):
        """The numpy array or tensor (a ``HostTensor``) of the field."""
        return self._values

    @values.setter
    def values(self, values):
        if type(values) is torch.Tensor:
            values = values.as_subclass(HostTensor)
        self._values = values

    def __init__(self, values, dims=None, attrs=None, name=None):
        if isinstance(values, DataArray):
            dims = dims if dims is not None else values.dims
            attrs = attrs if attrs is not None else values.attrs
            values = values.values
        if not isinstance(values, torch.Tensor) and (
                np.isscalar(values) or (hasattr(values, 'ndim')
                                        and values.ndim == 0)):
            values = np.asarray(values)
        self.values = values
        if dims is None:
            dims = tuple('dim_{}'.format(i) for i in range(values.ndim))
        dims = tuple(dims)
        if len(dims) != values.ndim:
            raise ValueError(
                'dims {} do not match array of rank {}'.format(
                    dims, values.ndim))
        self.dims = dims
        self.attrs = dict(attrs) if attrs else {}
        self.name = name

    # -- basic array protocol -------------------------------------------------
    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def size(self):
        if isinstance(self.values, torch.Tensor):
            return self.values.numel()
        return self.values.size

    def __len__(self):
        return len(self.values)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(to_numpy(self.values), dtype=dtype)

    @property
    def units(self):
        return self.attrs.get('units', 'dimensionless')

    # -- units ---------------------------------------------------------------
    def to_units(self, units: str) -> 'DataArray':
        """Return a new DataArray converted to the given units."""
        if units_are_same(self.units, units):
            out = DataArray(self.values, self.dims, self.attrs, self.name)
            out.attrs['units'] = units
            return out
        scale, shift = conversion_factor(self.units, units)
        values = self.values * scale
        if shift != 0.0:
            values = values + shift
        attrs = dict(self.attrs)
        attrs['units'] = units
        return DataArray(values, self.dims, attrs, self.name)

    # -- xarray-compatible helpers -------------------------------------------
    def transpose(self, *dims) -> 'DataArray':
        if not dims:
            dims = self.dims[::-1]
        axes = [self.dims.index(d) for d in dims]
        return DataArray(transpose(self.values, axes), dims, self.attrs,
                         self.name)

    def rename(self, name) -> 'DataArray':
        return DataArray(self.values, self.dims, self.attrs, name)

    def copy(self) -> 'DataArray':
        values = self.values
        if isinstance(values, torch.Tensor):
            values = values.clone()
        elif isinstance(values, np.ndarray):
            values = values.copy()
        return DataArray(values, self.dims, self.attrs, self.name)

    def _reduce(self, np_name, torch_fn, axis, kw):
        values = self.values
        if not isinstance(values, torch.Tensor):
            result = getattr(values, np_name)(axis=axis, **kw)
        elif axis is None:
            result = torch_fn(values, **kw)
        else:
            result = torch_fn(values, dim=axis, **kw)
        return self._reduce_result(result, axis)

    def mean(self, axis=None, **kw):
        return self._reduce('mean', torch.mean, axis, kw)

    def sum(self, axis=None, **kw):
        return self._reduce('sum', torch.sum, axis, kw)

    def min(self, axis=None, **kw):
        return self._reduce(
            'min', torch.min if axis is None else torch.amin, axis, kw)

    def max(self, axis=None, **kw):
        return self._reduce(
            'max', torch.max if axis is None else torch.amax, axis, kw)

    def _reduce_result(self, result, axis):
        if axis is None:
            return DataArray(result, (), self.attrs, self.name)
        if isinstance(axis, int):
            axis = (axis,)
        axis = tuple(a % self.ndim for a in axis)
        dims = tuple(d for i, d in enumerate(self.dims) if i not in axis)
        return DataArray(result, dims, self.attrs, self.name)

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        # expand Ellipsis
        if Ellipsis in key:
            i = key.index(Ellipsis)
            n_explicit = len([k for k in key if k is not Ellipsis])
            key = (key[:i] + (slice(None),) * (self.ndim - n_explicit)
                   + key[i + 1:])
        new_dims = []
        di = 0
        for k in key:
            if isinstance(k, (int, np.integer)):
                di += 1
            elif k is None:
                new_dims.append('dim_new_{}'.format(len(new_dims)))
            else:
                new_dims.append(self.dims[di])
                di += 1
        new_dims.extend(self.dims[di:])
        return DataArray(self.values[key], tuple(new_dims), self.attrs,
                         self.name)

    def __setitem__(self, key, value):
        if isinstance(value, DataArray):
            value = value.values
        if isinstance(self.values, torch.Tensor):
            _, value = common_backend(self.values, value)
        else:
            value = to_numpy(value)
        self.values[key] = value

    # -- arithmetic (dims/attrs follow the left operand) ----------------------
    def _binop(self, other, op, keep_units):
        ov = other.values if isinstance(other, DataArray) else other
        result = op(*common_backend(self.values, ov))
        attrs = dict(self.attrs) if keep_units else {}
        dims = self.dims
        if hasattr(result, 'ndim') and result.ndim != self.ndim:
            if (isinstance(other, DataArray)
                    and result.ndim == other.values.ndim):
                dims = other.dims
            else:
                dims = None
        return DataArray(result, dims, attrs, self.name)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b, True)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a, True)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b, True)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a, True)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b, False)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a, False)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b, False)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a, False)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b, False)

    def __neg__(self):
        return DataArray(-self.values, self.dims, self.attrs, self.name)

    def __abs__(self):
        return DataArray(abs(self.values), self.dims, self.attrs, self.name)

    def _inplace(self, o, iop, op):
        ov = o.values if isinstance(o, DataArray) else o
        if (isinstance(self.values, np.ndarray)
                and not isinstance(ov, torch.Tensor)):
            self.values = iop(self.values, ov)
        else:
            self.values = op(*common_backend(self.values, ov))
        return self

    def __iadd__(self, o):
        return self._inplace(o, operator.iadd, operator.add)

    def __isub__(self, o):
        return self._inplace(o, operator.isub, operator.sub)

    def __imul__(self, o):
        return self._inplace(o, operator.imul, operator.mul)

    # comparisons return raw boolean arrays (like xarray's .values semantics)
    def _compare(self, o, op):
        ov = o.values if isinstance(o, DataArray) else o
        return op(*common_backend(self.values, ov))

    def __eq__(self, o):
        return self._compare(o, operator.eq)

    def __ne__(self, o):
        return self._compare(o, operator.ne)

    def __lt__(self, o):
        return self._compare(o, operator.lt)

    def __le__(self, o):
        return self._compare(o, operator.le)

    def __gt__(self, o):
        return self._compare(o, operator.gt)

    def __ge__(self, o):
        return self._compare(o, operator.ge)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return ('<DataArray {} dims={} units={!r}>\n{}'.format(
            'x'.join(str(s) for s in self.shape), self.dims, self.units,
            self.values))


def transpose(values, axes):
    """``np.transpose`` of a numpy array, ``permute`` of a tensor."""
    if isinstance(values, torch.Tensor):
        return values.permute(*axes)
    return np.transpose(values, axes)
