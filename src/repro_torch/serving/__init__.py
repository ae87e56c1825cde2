"""The simulated heterogeneous serving cluster and its workload."""
