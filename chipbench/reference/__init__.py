"""Plain references, one a configuration: they import nothing of the
program and take nothing it made."""
