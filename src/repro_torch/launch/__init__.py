"""Launch layer (port of ``repro.launch``): device meshes, the dry run of
one rank's program on meta tensors, its op cost and roofline at H100
peaks, and the hill-climb runner."""
