"""Training core of the port: schedules, train state, train steps."""
