"""The general loops a traffic file names under ``driver``."""
