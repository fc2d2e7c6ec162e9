from repro_torch.state.kv import GlobalTier, RWLock, DEFAULT_CHUNK
from repro_torch.state.local import LocalTier, Replica
from repro_torch.state.wire import (INT8_WIRE_MIN_BYTES, WIRES, WireFrame,
                              WirePolicy, get_codec)
from repro_torch.state.ddo import (Counter, DistDict, MatrixReadOnly,
                             SparseMatrixReadOnly, VectorAsync)

__all__ = ["GlobalTier", "RWLock", "DEFAULT_CHUNK", "LocalTier", "Replica",
           "INT8_WIRE_MIN_BYTES", "WIRES", "WireFrame", "WirePolicy",
           "get_codec", "Counter", "DistDict", "MatrixReadOnly",
           "SparseMatrixReadOnly", "VectorAsync"]
