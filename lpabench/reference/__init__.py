"""The plain reference the program is held to: ``lpa.detect``."""
