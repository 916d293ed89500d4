"""Training of the port: losses, schedule, optimizer step, fusion trainer."""
