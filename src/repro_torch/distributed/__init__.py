"""The training fleet: host-plane elastic membership (:mod:`.elastic`) and
fault tolerance (:mod:`.fault`), and the device-plane weight broadcast
(:mod:`.broadcast`).  Import the modules themselves; this package imports
nothing on its own."""
