"""Multi-device decode of one stream: the time-sharded demodulation with its
halo exchange (sharding.py) and the multi-process session around it
(multihost.py, multihost_worker.py).  Port of dump1090_tpu/parallel/."""
