"""Training: the losses, the three stages and their stage files, in the JAX
package's .npz format."""
