"""Configurations: ``<name>.json`` holds the settings as they are run, and
``<name>.py`` beside it builds the program's entry, its plain reference and
control, and counts its operations and bytes."""
