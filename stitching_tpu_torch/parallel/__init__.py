"""Multi-GPU stitching: the process group and its collectives
(`parallel.mesh`)."""
