"""Semi-Lagrangian advection with moving boundaries, on torch."""
