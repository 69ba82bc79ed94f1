"""The loops that drive the program, one a traffic kind."""
