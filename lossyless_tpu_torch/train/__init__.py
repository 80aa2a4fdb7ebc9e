"""Training state: optimizer groups, schedules, train and eval steps."""
