"""Train step, evaluation, schedules, data, metrics and checkpoints for the
port's trainers."""
