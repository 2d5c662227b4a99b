"""The port's benchmark: cells, configurations, traffic and metric readers
found by name, the plain reference they are judged against, and the
arithmetic of rooflines and utilization. See ``run.py``."""
