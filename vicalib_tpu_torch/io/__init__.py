"""Sources, outputs, the simulator and the native host library."""
