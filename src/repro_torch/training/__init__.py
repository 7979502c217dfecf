"""Training: the optimizers (``optimizer``), gradient compression with
error feedback (``compression``) and the train step and loop
(``train_loop``)."""
