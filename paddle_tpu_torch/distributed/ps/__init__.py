"""The parameter-server tier: the KV server and client (kv_server.py),
the transpiler and fleet's PS meta-optimizer (ps_optimizer.py) and the
runtime fleet's init_worker / init_server / run_server / stop_worker
call (the_one_ps.py).  Counterpart of paddle_tpu/distributed/ps/: host
code over TCP; a trainer's dense step runs on its executor's device."""
