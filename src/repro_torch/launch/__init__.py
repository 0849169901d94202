"""Entry points of the port's LM stack: the train, eval and serving steps
(``steps``) and the training driver (``train``)."""
