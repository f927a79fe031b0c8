"""One module a learning-rate schedule, named as the traffic file's
``optimizer.schedule.name`` names the program's: ``lr(args, step)``, the
float32 rate of ``step``."""
