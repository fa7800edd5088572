"""PyTorch/CUDA port of the k8s_gpu_tpu model plane, held against the JAX
package (``k8s_gpu_tpu``) as its reference.  See README, "PyTorch port"."""
