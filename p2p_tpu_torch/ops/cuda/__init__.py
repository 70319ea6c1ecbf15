"""The port's hand-written Hopper kernels, each beside its plain version."""
