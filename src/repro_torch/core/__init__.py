"""The allreduce system: the packet simulator (``canary``) and the
record -> compile -> replay bridge (``trace``)."""
