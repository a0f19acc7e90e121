"""One module per kind of traffic, named by a traffic file's ``driver``."""
