from . import params, timing, profiling
