"""The distributed layer: gradient compression, the parameter-placement
rules on a DeviceMesh (``sharding``) and spawned gloo ranks (``ranks``)."""
