"""The benchmark harness of the PyTorch and CUDA port (`repro_torch`).

Everything here is the yardstick: it finds a cell's configuration,
traffic mix and metric readers by name (`cells`), makes the weights and
the data from the run's seed (`weights`, `markov`), counts the work a
cell needs from the model's shapes (`yardstick`), reads the profiler's
trace (`profiling`) and decides `correct` against the plain reference in
`bench/reference/` (`checks`). Nothing here imports JAX or the JAX
package; the port is imported only inside the functions that drive it.
"""
