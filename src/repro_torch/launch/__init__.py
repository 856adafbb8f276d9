"""Launch-side tools of the port: ``report`` renders a run's telemetry
log (the training and serving drivers are not ported yet)."""
