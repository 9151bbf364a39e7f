"""Runtime policy of the port: the draft tier's packing configuration."""
