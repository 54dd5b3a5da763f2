"""Entry points of the port: ``fig2`` (paper Fig. 2 convergence) and
``volunteer_grid`` (the 4096-host batched grid)."""
