"""Runtime policy of the port: the planner (and the draft tier's packing
configuration) and the fault-tolerant step runner."""
