"""Host-plane coordination of the training fleet: elastic membership
(:mod:`.elastic`) and fault tolerance (:mod:`.fault`).  Import the modules
themselves; this package imports nothing on its own."""
