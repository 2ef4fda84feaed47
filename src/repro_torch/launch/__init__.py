"""Launch helpers of the port: device meshes (`mesh`) and the
data-parallel collectives (`transport`)."""
