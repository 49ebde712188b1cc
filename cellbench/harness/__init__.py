"""The yardstick: inputs from the seed, the general generator, the trace's
reduction, the roofline, the plain reference and the check."""
