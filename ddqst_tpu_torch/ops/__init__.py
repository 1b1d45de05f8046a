"""Compute-path ops: schedules, diffusion samplers, the CUDA chain walk,
Pauli inversion, histograms and metrics."""
