"""Host data handling of the port: NIfTI I/O, the Decathlon datalist, the
preprocessing transforms and the validation pipelines (copies of the JAX
package's ``medseg/data`` modules, numpy only)."""
