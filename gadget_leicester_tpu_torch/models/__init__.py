"""Grid cache, integrator, forces, driver and initial conditions."""
