"""Per model family, how the benchmark states a configuration file's sizes
to the program (``program_config``). A new family is a new module here and
one in ``reference/``."""
