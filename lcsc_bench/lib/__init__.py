"""The benchmark's yardstick: discovery, inputs, work counts, peaks, the
power sampler and the profiler's reader."""
