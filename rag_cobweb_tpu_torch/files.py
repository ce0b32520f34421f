"""Reading and writing the JAX package's files without the JAX package.

A ``CobwebIndex.save`` file is an ``.npz`` whose ``sentences`` entry is an
object array (pickled by numpy) and whose ``whitener_pickle`` entry holds
``pickle.dumps`` of one of the JAX package's whitening models
(``PCAICAWhiteningModel``, ``PCAZCAWhiteningModel``,
``ZCAWhiteningModel``).  A plain ``pickle.loads`` of either would import
whatever the stream names: the JAX whitener's class, and, once that
whitener has served a query, the ``jax._src.array._reconstruct_array`` of
the device arrays cached in its ``_jax_cache``.  Here every stream goes through ``restricted_loads``,
which resolves only the names below and imports nothing:

* numpy's own array and scalar reconstructors, ``numpy.ndarray`` and
  ``numpy.dtype`` (the pieces of a pickled numpy array);
* ``rag_cobweb_tpu.whitening.models.PCAICAWhiteningModel``,
  ``.PCAZCAWhiteningModel`` and ``.ZCAWhiteningModel``, each mapped to the
  port's class of that name;
* ``jax._src.array._reconstruct_array``, mapped to a function that
  rebuilds the numpy value and builds no JAX object.

Any other name raises ``pickle.UnpicklingError``.  ``whitener_pickle``
writes the port's whitener as a stream that names the JAX class of the
same name (its fields and an empty ``_jax_cache``), so the JAX package
serves from a file the port wrote; its opcodes are emitted here, so
writing it imports nothing of the JAX package either.  A string that
names a module is not an import.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

from rag_cobweb_tpu_torch.whitening.models import (PCAICAWhiteningModel,
                                                   PCAZCAWhiteningModel,
                                                   ZCAWhiteningModel)

JAX_WHITENER_MODULE = "rag_cobweb_tpu.whitening.models"
WHITENERS = {cls.__name__: cls for cls in (
    PCAICAWhiteningModel, PCAZCAWhiteningModel, ZCAWhiteningModel)}
_JAX_ARRAY = ("jax._src.array", "_reconstruct_array")
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
# the callables a pickled numpy array or scalar names, taken from this
# numpy's own reductions
_NUMPY_NAMES = {"_reconstruct": np.zeros(0).__reduce__()[0],
                "scalar": np.float32(0).__reduce__()[0],
                "ndarray": np.ndarray, "dtype": np.dtype}


def _reconstruct_array(fun, args, arr_state, aval_state):
    """What ``jax._src.array._reconstruct_array`` does before it moves the
    value to a device: the numpy value alone."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == JAX_WHITENER_MODULE and name in WHITENERS:
            return WHITENERS[name]
        if (module, name) == _JAX_ARRAY:
            return _reconstruct_array
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return _NUMPY_NAMES[name]
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def restricted_loads(data: bytes):
    """``pickle.loads`` that resolves only the names of this module's
    docstring."""
    return _Unpickler(io.BytesIO(data)).load()


def read_pickle(path: str):
    """A pickle file of either package (a trainer's parameters: nested
    dicts and tuples of numpy arrays) through ``restricted_loads``."""
    with open(path, "rb") as f:
        return restricted_loads(f.read())


def read_npz(path: str) -> dict:
    """Every array of an ``.npz`` file, object arrays (a wrapper file's
    sentences) read through ``restricted_loads``."""
    fmt = np.lib.format
    out = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            with data.zip.open(key + ".npy") as f:
                version = fmt.read_magic(f)
                header = (fmt.read_array_header_1_0 if version == (1, 0)
                          else fmt.read_array_header_2_0)
                _, _, dtype = header(f)
                out[key] = (restricted_loads(f.read()) if dtype.hasobject
                            else data[key])
    return out


def whitener_from_pickle(data: bytes):
    """The port's whitener (of the class the stream names) from a
    ``whitener_pickle`` written by either package; the JAX package's
    ``_jax_cache`` is dropped."""
    obj = restricted_loads(data)
    if type(obj) not in WHITENERS.values():
        raise pickle.UnpicklingError(
            f"whitener_pickle holds a {type(obj).__name__}")
    return type(obj).from_dict(vars(obj))


def whitener_pickle(w) -> bytes:
    """The whitener as the JAX package pickles its own: ``GLOBAL`` naming
    the JAX class of the same name, ``EMPTY_TUPLE`` + ``NEWOBJ``
    (``cls.__new__(cls)``), then ``BUILD`` with the instance dict (the
    class's ``FIELDS`` and ``_jax_cache=None``).  The dict is pickled at
    protocol 3, which frames nothing, so its opcodes sit between ours as
    they are."""
    name = type(w).__name__
    if WHITENERS.get(name) is not type(w):
        raise TypeError(f"not a whitening model of the port: {name}")
    state = {f: getattr(w, f) for f in w.FIELDS}
    state["_jax_cache"] = None
    body = pickle.dumps(state, protocol=3)
    if body[:2] != pickle.PROTO + b"\x03" or body[-1:] != pickle.STOP:
        raise ValueError("unexpected pickle framing")
    return (pickle.PROTO + b"\x03"
            + pickle.GLOBAL + f"{JAX_WHITENER_MODULE}\n{name}\n".encode()
            + pickle.EMPTY_TUPLE + pickle.NEWOBJ
            + body[2:-1] + pickle.BUILD + pickle.STOP)
