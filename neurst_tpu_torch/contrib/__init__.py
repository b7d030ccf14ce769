"""User plug-ins shipped with the port.  They register their entries
when ``run_exp --include`` names them (a file path or a module name);
importing the package does not import them."""
