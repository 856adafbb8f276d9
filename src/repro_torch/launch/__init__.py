"""Launch-side tools of the port: the training and serving drivers
(``train``, ``serve``), the client and production meshes (``mesh``),
the step builders (``build``), the counting tools (``cost_model``,
``hlo_stats``), the dry-run (``dryrun``) and the reports (``report``)."""
