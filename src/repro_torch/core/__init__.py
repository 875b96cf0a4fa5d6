"""The CNA discipline core, its topologies and the admission queues (copies
of the modules of ``repro.core`` that the serving scheduler needs)."""

from .discipline import CNADiscipline, FIFODiscipline, Grant, RestrictedDiscipline  # noqa: F401
from .policy import CNAAdmissionQueue, FIFOAdmissionQueue  # noqa: F401
from .topology import Topology, flat, get_topology, pod, table  # noqa: F401
