"""Train step, schedules and synthetic data for the port's trainers."""
