"""The training fleet: host-plane elastic membership (:mod:`.elastic`) and
fault tolerance (:mod:`.fault`), the device-plane weight broadcast
(:mod:`.broadcast`), and the mesh layer: the sharding rules
(:mod:`.sharding`) and the context through which model code constrains its
activations (:mod:`.api`).  Import the modules themselves; this package
imports nothing on its own."""
