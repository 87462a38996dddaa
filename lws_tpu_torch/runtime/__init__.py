"""Worker workloads run by a group's members (runtime/worker.py)."""
