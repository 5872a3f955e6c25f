"""Energy diagnostics and the run's log files."""
