"""The allreduce system: the packet simulator (``canary``) with its
transport, fault, telemetry and fleet layers, the flow-level fast path
(``flow``), the record -> compile -> replay bridge (``trace``) and the
device collective (``collective``)."""
