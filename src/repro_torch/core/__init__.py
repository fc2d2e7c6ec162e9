"""FAASM core: Faaslets, host interface, Proto-Faaslets, scheduler, runtime."""
from repro_torch.core.faaslet import (CONTAINER_OVERHEAD_BYTES,
                                FAASLET_OVERHEAD_BYTES, ArenaBase, Faaslet,
                                FaasletMemoryFault, ResourceLimitExceeded)
from repro_torch.core.host_interface import CallCancelled, FaasmAPI, StateKeyError
from repro_torch.core.proto import ExecutableCache, ProtoFaaslet
from repro_torch.core.runtime import (BatchTimeout, Call, CompletionLatch,
                                FaasmRuntime, FunctionDef, Host)
from repro_torch.core.scheduler import LocalScheduler
from repro_torch.core.chain import await_all, chain, outputs
from repro_torch.core.vfs import VirtualFS

__all__ = [
    "ArenaBase", "Faaslet", "FaasletMemoryFault", "ResourceLimitExceeded",
    "FaasmAPI", "CallCancelled",
    "StateKeyError", "ExecutableCache", "ProtoFaaslet", "Call",
    "BatchTimeout", "CompletionLatch", "FaasmRuntime",
    "FunctionDef", "Host", "LocalScheduler", "await_all", "chain", "outputs",
    "VirtualFS", "FAASLET_OVERHEAD_BYTES", "CONTAINER_OVERHEAD_BYTES",
]
