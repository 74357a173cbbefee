"""The benchmark's yardstick: discovery of cells, configurations, drivers and
metric readers by name, input and weight generation from the seed, the
reduction of profiler traces, the operation and byte counts, the table of
peaks, the comparison that decides ``correct`` and the run itself.  Nothing
here imports the port at module level; the drivers import it when a run
builds its state."""
