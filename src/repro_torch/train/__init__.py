"""Training of the port: ZeRO-1 optimizer and the data-parallel step
(counterpart of ``repro/train``)."""
