"""The CNA discipline core, its topologies, the threaded lock, the NUMA
simulator and its locks, and the admission queues (copies of the modules of
``repro.core``)."""

from .discipline import (  # noqa: F401
    CNADiscipline,
    DisciplineConfig,
    DisciplineStats,
    FIFODiscipline,
    Grant,
    RestrictedDiscipline,
    Scan,
    SecondaryFlush,
    Shuffle,
    decide,
)
from .topology import Topology, flat, get_topology, pod, table  # noqa: F401
from .cna import CNALock, CNANode, MCSLock, run_lock_stress  # noqa: F401
from .policy import CNAAdmissionQueue, FIFOAdmissionQueue  # noqa: F401
from .numasim import CostModel, Simulator, SimResult, TWO_SOCKET, FOUR_SOCKET, run_sweep  # noqa: F401
from .locks_sim import ALL_LOCKS  # noqa: F401
