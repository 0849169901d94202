"""Entry points of the port's LM stack: the train, eval and serving steps
and their input specs (``steps``), the training driver (``train``), and
the dry-run on ``meta`` (``dryrun``) with its roofline (``roofline``,
``report``) against one H100's constants (``mesh``, which also makes the
reference's meshes as ranks), and the rank processes' launcher and jobs
(``ranks``)."""
