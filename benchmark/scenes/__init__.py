"""Scene kinds of the configurations: ``<kind>.py`` loads a
configuration's scene into the program (``program_scene``) and builds the
reference's tables from the configuration's own data
(``reference_tables``)."""
