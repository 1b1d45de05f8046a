"""Compute-path ops: schedules, diffusion samplers, the CUDA chain walk and
chain step, Pauli inversion, histograms and metrics."""
